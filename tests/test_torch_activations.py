"""The port's activations against the JAX package's (f32, CPU): every
entry of JAX's name table and ``sequence_softmax`` (with ``lengths``, a
``mask``, a ``[B, T, 1]`` input and none), values and gradients of
``sum(f(x) * g)`` (``jax.grad`` against autograd) on the same seeded
inputs (positive ones for log, sqrt and reciprocal; brelu's inputs
spanning both clips). Tolerance: rtol 1e-5, atol 1e-6 — the same f32
formulas through other libraries' kernels. Also ``get``'s table and its
refusal."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.nn import activations as J
from paddle_tpu_torch.nn import activations as T

POSITIVE = {"log", "sqrt", "reciprocal"}


def _input(name, shape=(4, 7)):
    rng = np.random.RandomState(sorted(J.ACTIVATIONS).index(name))
    if name in POSITIVE:
        return (rng.rand(*shape) * 3 + 0.2).astype(np.float32)
    scale = 20.0 if name == "brelu" else 3.0       # past both clips
    return (rng.randn(*shape) * scale).astype(np.float32)


def _check(jf, tf, x, g, **kw):
    want = np.asarray(jf(jnp.asarray(x), **kw))
    jg = np.asarray(jax.grad(lambda a: jnp.sum(jf(a, **kw) * g))(
        jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tf(xt, **{k: torch.from_numpy(np.asarray(v)) for k, v in
                    kw.items()})
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), jg, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", sorted(J.ACTIVATIONS))
def test_activation_and_gradient_match_jax(name):
    x = _input(name)
    g = np.random.RandomState(99).randn(*x.shape).astype(np.float32)
    _check(J.get(name), T.get(name), x, g)


@pytest.mark.parametrize("how", ["lengths", "mask", "squeeze", "none"])
def test_sequence_softmax_matches_jax(how):
    rng = np.random.RandomState(5)
    x = rng.randn(3, 6).astype(np.float32)
    kw = {}
    if how in ("lengths", "squeeze"):
        kw["lengths"] = np.array([6, 2, 0], np.int32)   # an empty row too
    if how == "mask":
        kw["mask"] = (rng.rand(3, 6) < 0.6).astype(np.float32)
    if how == "squeeze":
        x = x[..., None]
    g = rng.randn(*x.shape).astype(np.float32)
    _check(J.sequence_softmax, T.sequence_softmax, x, g, **kw)


def test_get_has_jax_s_table():
    assert sorted(T.ACTIVATIONS) == sorted(J.ACTIVATIONS)
    assert T.get(torch.tanh) is torch.tanh
    assert T.get("abs") is T.abs_act and T.get("") is T.identity
    with pytest.raises(KeyError, match="unknown activation"):
        T.get("swish")
    with pytest.raises(ValueError):
        T.get("swish")
    with pytest.raises(KeyError):
        J.get("swish")
