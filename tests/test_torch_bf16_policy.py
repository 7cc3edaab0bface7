"""The port's layers under the ``bfloat16_compute`` policy against the JAX
package's under the same policy (CPU), on numpy inputs from a seed and the
same weights: the policy objects; ``Linear`` and ``MultiHeadAttention``
(its ``"xla"`` and ``"flash"`` paths, the JAX flash kernel in interpret
mode) with the output and every gradient against ``jax.vjp``; ``Conv2D``
on each branch (3x3 at strides 1 and 2, the 1x1 ``"conv"``, ``"matmul"``
and ``"pallas"`` lowerings at strides 1 and 2, the 7x7/2 stem, which JAX
rewrites as space-to-depth); ``BatchNorm`` in training and inference;
``Pool2D``, ``GlobalPool`` and ``LayerNorm`` on bf16 inputs; and
``conv1x1_dw`` on bf16 operands against ``dw_pallas`` in interpret mode.
Three tests hold repairs of the port (each failed before it): the policy
product widens the sum, never rounding it to bf16 first; the ``"xla"``
attention path takes bf16 softmax weights against f32 values; the 1x1 dW
wrapper takes bf16 operands and refuses mixed ones.

Tolerances, each with its reason:

- a product of bf16 operands returned in f32 (``Linear``, the
  projections), and f32 sums of f32 cotangents (a bias gradient, behind
  gelu's derivative, which the two frameworks write differently): 1e-5
  of the largest entry. Products of bf16 values are exact in f32; only
  the order of the f32 sums differs.
- a gradient that JAX rounds to bf16 (the cast's VJP) or a bf16 output:
  at most one bf16 ulp apart entry by entry (``|port - jax| <= 2^-7 |jax|``).
  Two f32 sums in other orders round to neighbouring bf16 values where
  they straddle a rounding boundary. The 7x7/2 stem's space-to-depth
  rewrite sums the same products in another order, so it is held to the
  same one ulp.
- a bf16 reduction (a conv bias's gradient, an average pool's window sum,
  the inference ``BatchNorm``'s scale and shift gradients): XLA's CPU
  backend accumulates a bf16 reduce in bf16, the port in f32 with one
  rounding at the end. The port is held to one ulp of the f32 sum of the
  same bf16 terms, and JAX to that sum within the error of a bf16 running
  sum (``n * 2^-8`` of the largest partial sum for ``n`` terms).
- ``dw_pallas`` on bf16 operands: both sum exact products in f32, in
  other orders: 1e-5 of the largest entry.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.core import dtypes as jdt
from paddle_tpu.nn import pallas_conv
from paddle_tpu.nn.attention import MultiHeadAttention as JMHA
from paddle_tpu.nn.layers import BatchNorm as JBatchNorm
from paddle_tpu.nn.layers import Conv2D as JConv2D
from paddle_tpu.nn.layers import GlobalPool as JGlobalPool
from paddle_tpu.nn.layers import LayerNorm as JLayerNorm
from paddle_tpu.nn.layers import Linear as JLinear
from paddle_tpu.nn.layers import Pool2D as JPool2D
from paddle_tpu.nn.layers import set_conv1x1_impl as jset_impl
import paddle_tpu_torch as pt
from paddle_tpu_torch.core import dtypes as tdt
from paddle_tpu_torch.nn import cuda_conv as cc
from paddle_tpu_torch.nn.attention import MultiHeadAttention
from paddle_tpu_torch.nn.layers import (BatchNorm, Conv2D, GlobalPool,
                                        LayerNorm, Linear, Pool2D)
from paddle_tpu_torch.utils import cuda_build

RTOL_F32 = 1e-5
BF16_ULP = 2.0 ** -7   # one bf16 ulp, relative, at the bottom of a binade


def _f32(a):
    """numpy f32 of a JAX array or torch tensor (bf16 widened)."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close_f32(got, want, what=""):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= RTOL_F32 * np.abs(want).max(), f"{what}: {err}"


def _one_ulp(got, want, what=""):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, what
    bad = np.abs(got - want) > BF16_ULP * np.abs(want)
    assert not bad.any(), (f"{what}: {bad.sum()} entries past one bf16 ulp, "
                           f"worst {np.abs(got - want)[bad].max()}")


def _bf16(a):
    """A numpy array rounded to bf16, as a torch bf16 tensor and the same
    values as a JAX bf16 array."""
    t = torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _set(param, array):
    with torch.no_grad():
        param.copy_(torch.from_numpy(np.array(array, np.float32)))


def _params(variables):
    (p,) = variables["params"].values()
    return p


def _jax_vjp(module, variables, x, cotangent, **kw):
    """JAX forward under bfloat16_compute and the VJP of its parameters and
    input with ``cotangent`` (cast to the output's dtype)."""
    def f(params, x):
        with jdt.use_policy(jdt.bfloat16_compute):
            return module.apply({**variables, "params": params}, x, **kw)
    y, vjp = jax.vjp(f, variables["params"], x)
    gp, gx = vjp(jnp.asarray(cotangent).astype(y.dtype))
    return y, _params({"params": gp}), gx


def test_policy_objects_and_canonicalize():
    jb, tb = jdt.bfloat16_compute, pt.bfloat16_compute
    for field in ("param_dtype", "compute_dtype", "accum_dtype"):
        assert str(getattr(tb, field)).split(".")[-1] == \
            jnp.dtype(getattr(jb, field)).name
    assert pt.float32 == tdt.Policy() and pt.current_policy() == pt.float32
    for name in ("float32", "bfloat16", "float16", "int32", "int8"):
        assert pt.canonicalize(name) == getattr(torch, name)
        assert jnp.dtype(jdt.canonicalize(name)).name == name
    assert pt.canonicalize(torch.bfloat16) is torch.bfloat16
    x = torch.ones(2, dtype=torch.bfloat16)
    assert tb.cast_accum(x).dtype == torch.float32
    assert tb.cast_compute(x.float()).dtype == torch.bfloat16
    with pt.use_policy(tb):
        assert pt.current_policy() is tb
    assert pt.current_policy() == pt.float32


def test_repair_policy_product_widens_without_rounding():
    """Under a bf16 compute policy ``Linear`` returns the f32 sum of the
    bf16 operands' exact products (JAX's ``preferred_element_type``), not
    that sum rounded to bf16."""
    rng = np.random.RandomState(3)
    lin = Linear(64, 32, device="cpu")
    _set(lin.w, rng.randn(64, 32))
    x = torch.from_numpy(rng.randn(16, 64).astype(np.float32))
    pol = tdt.Policy(torch.float32, torch.bfloat16, torch.float32)
    with pt.use_policy(pol):
        y = lin(x)
    want = x.bfloat16().float() @ lin.w.detach().bfloat16().float()
    assert y.dtype == torch.float32
    _close_f32(y, want, "y")
    # a bf16-rounded sum would be off by up to a bf16 ulp, far past this
    assert not torch.equal(y, y.bfloat16().float())


@pytest.mark.parametrize("act", ["", "gelu"])
def test_linear_matches_jax_vjp(act):
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 16).astype(np.float32)
    gy = rng.randn(3, 5, 24).astype(np.float32)
    jl = JLinear(24, act=act)
    vs = jl.init(jax.random.PRNGKey(0), jnp.asarray(x))
    vs = {"params": jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32)),
        vs["params"])}
    y, gp, gx = _jax_vjp(jl, vs, jnp.asarray(x), gy)
    p = _params(vs)
    tl = Linear(16, 24, act=act, device="cpu")
    _set(tl.w, p["w"])
    _set(tl.b, p["b"])
    xt = torch.from_numpy(x).requires_grad_()
    with pt.use_policy(pt.bfloat16_compute):
        yt = tl(xt)
    yt.backward(torch.from_numpy(gy))
    assert y.dtype == jnp.float32 and yt.dtype == torch.float32
    _close_f32(yt, y, "y")
    assert xt.grad.dtype == torch.float32
    _one_ulp(xt.grad, gx, "dx")
    _one_ulp(tl.w.grad, gp["w"], "dw")
    _close_f32(tl.b.grad, gp["b"], "db")       # f32 sum of the f32 cotangent


def _mha_case(impl, rng):
    B, T, D, H = 2, 32, 32, 4
    x = rng.randn(B, T, D).astype(np.float32)
    gy = rng.randn(B, T, D).astype(np.float32)
    jm = JMHA(H, use_flash=impl == "flash")
    vs = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), causal=True)
    tm = MultiHeadAttention(D, H, use_flash=impl == "flash", device="cpu")
    for name, arr in _params(vs).items():
        _set(getattr(tm, name), arr)
    return x, gy, jm, vs, tm


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_mha_matches_jax_vjp(impl):
    """Output and the gradients of the input and of ``wq``/``wk``/``wv``/
    ``wo``. The ``"xla"`` case is also the repair of the path's mixed
    dtypes: the bf16 softmax weights meet the f32 ``v`` (``torch.einsum``
    refused that before, where ``jnp`` promotes)."""
    x, gy, jm, vs, tm = _mha_case(impl, np.random.RandomState(5))
    y, gp, gx = _jax_vjp(jm, vs, jnp.asarray(x), gy, causal=True)
    xt = torch.from_numpy(x).requires_grad_()
    with pt.use_policy(pt.bfloat16_compute):
        yt = tm(xt, causal=True)
    yt.backward(torch.from_numpy(gy))
    assert yt.dtype == torch.float32
    # the context is rounded to bf16 before the out projection, so two
    # contexts one bf16 ulp apart move the output by that ulp's product
    lim = BF16_ULP * np.abs(_f32(y)).max()
    assert np.abs(_f32(yt) - _f32(y)).max() <= lim
    for name in ("wq", "wk", "wv", "wo"):
        g, want = _f32(getattr(tm, name).grad), _f32(gp[name])
        assert np.abs(g - want).max() <= 2 * BF16_ULP * np.abs(want).max(), \
            name
    g, want = _f32(xt.grad), _f32(gx)
    assert np.abs(g - want).max() <= 2 * BF16_ULP * np.abs(want).max()


CONV_CASES = [  # kernel, stride, in channels, 1x1 lowering, spatial size
    (3, 1, 5, "conv", 8), (3, 2, 5, "conv", 8), (1, 1, 8, "conv", 8),
    (1, 1, 8, "matmul", 8), (1, 1, 8, "pallas", 8), (1, 2, 8, "pallas", 8),
    (1, 2, 8, "matmul", 8), (7, 2, 3, "conv", 16)]


@pytest.mark.parametrize("kernel,stride,cin,impl,size", CONV_CASES)
def test_conv2d_branches_match_jax(kernel, stride, cin, impl, size):
    """bf16 output, input and weight gradients within one bf16 ulp of
    JAX's (bit-equal here, but the sums' order is not the same), the bias
    gradient as the module note says."""
    rng = np.random.RandomState(7)
    x = rng.randn(2, size, size, cin).astype(np.float32)
    jc = JConv2D(6, kernel, stride=stride)
    vs = jc.init(jax.random.PRNGKey(1), jnp.asarray(x))
    prev = jset_impl(impl)
    try:
        y = jc.apply(vs, jnp.asarray(x))                     # shape only
        gy = rng.randn(*y.shape).astype(np.float32)
        y, gp, gx = _jax_vjp(jc, vs, jnp.asarray(x), gy)
    finally:
        jset_impl(prev)
    p = _params(vs)
    tc = Conv2D(cin, 6, kernel, stride=stride, device="cpu")
    _set(tc.w, p["w"])
    _set(tc.b, p["b"])
    prev = pt.set_conv1x1_impl(impl)
    try:
        xt = torch.from_numpy(x).requires_grad_()
        with pt.use_policy(pt.bfloat16_compute):
            yt = tc(xt)
        gyt = torch.from_numpy(gy).bfloat16()
        yt.backward(gyt)
    finally:
        pt.set_conv1x1_impl(prev)
    assert y.dtype == jnp.bfloat16 and yt.dtype == torch.bfloat16
    _one_ulp(yt, y, "y")
    assert xt.grad.dtype == torch.float32 and tc.w.grad.dtype == torch.float32
    _one_ulp(xt.grad, gx, "dx")
    _one_ulp(tc.w.grad, gp["w"], "dw")
    _bf16_reduction(tc.b.grad, gp["b"], gyt.float().sum((0, 1, 2)),
                    gy[..., 0].size, "db")


def _bf16_reduction(got, jax_got, f32_sum, n, what):
    """A bf16 sum of ``n`` terms: the port within one ulp of the f32 sum
    (``f32_sum``, of the same bf16 terms), JAX within a bf16 running sum's
    error of it (see the module note)."""
    want = _f32(f32_sum)
    _one_ulp(_f32(got), want.astype(np.float32), f"{what} (port)")
    lim = n * 2.0 ** -8 * np.abs(want).max()
    assert np.abs(_f32(jax_got) - want).max() <= lim, f"{what} (jax)"


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_matches_jax(train):
    """f32 moments and running statistics, the normalization in bf16; in
    training the closed-form backward (dgamma and dbeta summed in f32), in
    inference autograd's (a bf16 reduction, see the module note)."""
    rng = np.random.RandomState(11)
    xt, xj = _bf16(rng.randn(4, 6, 6, 8) * 2 + 1)
    gt, gj = _bf16(rng.randn(4, 6, 6, 8))
    sc, sh = rng.randn(8), rng.randn(8)
    mean0, var0 = rng.randn(8) * 0.1, rng.rand(8) + 0.5
    jb = JBatchNorm()
    vs = jb.init(jax.random.PRNGKey(0), xj, train=train)
    (pk,), (sk,) = vs["params"].keys(), vs["state"].keys()
    params = {pk: {"scale": jnp.asarray(sc, jnp.float32),
                   "shift": jnp.asarray(sh, jnp.float32)}}
    state = {sk: {"mean": jnp.asarray(mean0, jnp.float32),
                  "var": jnp.asarray(var0, jnp.float32)}}

    def f(p, x):
        if train:
            return jb.apply({"params": p, "state": state}, x, train=True,
                            mutable=["state"])
        return jb.apply({"params": p, "state": state}, x), None
    y, new_state = f(params, xj)
    gp, gx = jax.vjp(lambda p, x: f(p, x)[0], params, xj)[1](gj)
    gp = gp[pk]
    tb = BatchNorm(8, device="cpu")
    for t, a in ((tb.scale, sc), (tb.shift, sh), (tb.mean, mean0),
                 (tb.var, var0)):
        _set(t, a)
    xg = xt.clone().requires_grad_()
    with pt.use_policy(pt.bfloat16_compute):
        yt = tb(xg, train=train)
    yt.backward(gt)
    assert yt.dtype == torch.bfloat16 and xg.grad.dtype == torch.bfloat16
    assert tb.mean.dtype == tb.var.dtype == torch.float32
    _one_ulp(yt, y, "y")
    _one_ulp(xg.grad, gx, "dx")
    if train:
        (ns,) = new_state["state"].values()
        _close_f32(tb.mean, ns["mean"], "running mean")
        _close_f32(tb.var, ns["var"], "running var")
        _close_f32(tb.scale.grad, gp["scale"], "dscale")
        _close_f32(tb.shift.grad, gp["shift"], "dshift")
    else:
        inv = torch.rsqrt(torch.from_numpy(var0).float() + tb.eps)
        xhat = (xt - torch.from_numpy(mean0).float().bfloat16()) \
            * inv.bfloat16()
        _bf16_reduction(tb.scale.grad, gp["scale"],
                        (gt * xhat).float().sum((0, 1, 2)), 4 * 36,
                        "dscale")
        _bf16_reduction(tb.shift.grad, gp["shift"],
                        gt.float().sum((0, 1, 2)), 4 * 36, "dshift")


@pytest.mark.parametrize("kind,window,stride,padding", [
    ("max", 3, 2, "SAME"), ("avg", 3, 2, "SAME"), ("avg", 2, 2, "VALID")])
def test_pool2d_on_bf16(kind, window, stride, padding):
    rng = np.random.RandomState(13)
    xt, xj = _bf16(rng.randn(2, 7, 7, 4) * 3)
    y = JPool2D(kind, window, stride, padding).apply({}, xj)
    yt = Pool2D(kind, window, stride, padding)(xt)
    assert y.dtype == jnp.bfloat16 and yt.dtype == torch.bfloat16
    if kind == "max":
        assert np.array_equal(_f32(yt), _f32(y))
        return
    want = Pool2D(kind, window, stride, padding)(xt.float())
    _bf16_reduction(yt, y, want, window * window, "avg pool")


@pytest.mark.parametrize("kind", ["avg", "max"])
def test_global_pool_and_layernorm_on_bf16(kind):
    rng = np.random.RandomState(17)
    xt, xj = _bf16(rng.randn(3, 5, 5, 16) * 2 + 0.5)
    y = JGlobalPool(kind).apply({}, xj)
    yt = GlobalPool(kind)(xt)
    assert y.dtype == jnp.bfloat16 and yt.dtype == torch.bfloat16
    _one_ulp(yt, y, "global pool")
    jl = JLayerNorm()
    vs = jl.init(jax.random.PRNGKey(0), xj)
    tl = LayerNorm(16, device="cpu")
    _set(tl.scale, _params(vs)["scale"])
    _set(tl.bias, _params(vs)["bias"])
    y = jl.apply(vs, xj)
    yt = tl(xt)
    assert y.dtype == jnp.bfloat16 and yt.dtype == torch.bfloat16
    _one_ulp(yt, y, "layernorm")


@pytest.mark.parametrize("m,cin,cout", [(160, 8, 24), (6144, 16, 32),
                                        (34, 3, 10)])
def test_conv1x1_dw_on_bf16_matches_dw_pallas(m, cin, cout):
    rng = np.random.RandomState(19)
    xt, xj = _bf16(rng.randn(m, cin))
    dyt, dyj = _bf16(rng.randn(m, cout))
    want = pallas_conv.dw_pallas(xj, dyj)
    got = cc.conv1x1_dw(xt, dyt)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    _close_f32(got, want, "dW")


def test_repair_dw_wrapper_takes_bf16_and_refuses_mixed():
    """The 1x1 dW wrapper routes bf16 operands to their own kernel,
    counted under its own name, and refuses mixed or other dtypes before
    it picks a path (on the card there is no fallback)."""
    assert cc.KERNELS["conv1x1_dw_bf16"] == "conv1x1_dw_bf16"
    assert (cuda_build.CSRC / "conv1x1_dw_bf16.cu").exists()
    assert set(cc.launch_counts()) == {"conv1x1_dw", "conv1x1_dw_bf16"}
    x = torch.randn(40, 8)
    dy = torch.randn(40, 6)
    assert cc.conv1x1_dw(x.bfloat16(), dy.bfloat16()).dtype == torch.float32
    for bad in [(x.bfloat16(), dy), (x, dy.bfloat16()), (x.half(), dy.half()),
                (x.double(), dy.double())]:
        with pytest.raises(ValueError):
            cc.conv1x1_dw(*bad)
