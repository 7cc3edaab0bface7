"""The port's initializers against the JAX package's on the same shapes
(CPU), and the layer arguments that take them:

- the fan rule (``fans`` against JAX's ``_fans``) on scalar, vector,
  matrix, HWIO and stacked-expert shapes, exactly;
- constant fills exactly; each random initializer's bound (uniform
  ones: every |value| within it, the largest within 2% of it) and
  standard deviation (within 3% of the formula, as JAX's own draw on
  the same shape is) — values cannot match JAX's PRNG;
- ``orthogonal(scale)``: QᵀQ = scale²·I (or QQᵀ for wide shapes) to
  1e-5, as JAX's;
- ``Linear(use_bias=False, w_init=...)`` and ``MultiHeadAttention(
  head_dim=..., out_dim=...)`` (both attention paths) against the JAX
  layers on bridged weights, atol 1e-5 (f32, other summation orders),
  with JAX's parameter trees (no ``b``; ``wo [H*hd, out_dim]``)."""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.core import initializers as J
from paddle_tpu.nn.attention import MultiHeadAttention as JMHA
from paddle_tpu.nn.layers import Linear as JLinear
from paddle_tpu_torch.core import initializers as T
from paddle_tpu_torch.nn.attention import MultiHeadAttention
from paddle_tpu_torch.nn.layers import Linear

SHAPES = [(), (7,), (64, 32), (3, 3, 16, 32), (8, 64, 256)]
BIG = [(512, 256), (3, 3, 64, 128), (8, 64, 256)]


@pytest.mark.parametrize("shape", SHAPES)
def test_fans_are_jax_s(shape):
    assert T.fans(shape) == J._fans(shape)


def _port(init, shape, seed=0):
    return init(torch.empty(shape), torch.Generator().manual_seed(seed))


def _jax(init, shape, seed=0):
    return np.asarray(init(jax.random.PRNGKey(seed), shape))


@pytest.mark.parametrize("shape", SHAPES)
def test_constant_fills(shape):
    for name, want in (("zeros", 0.0), ("ones", 1.0)):
        got = _port(getattr(T, name), shape)
        np.testing.assert_array_equal(got.numpy(),
                                      _jax(getattr(J, name), shape))
        assert (got == want).all()
    np.testing.assert_array_equal(_port(T.constant(0.25), shape).numpy(),
                                  _jax(J.constant(0.25), shape))


def _uniform_bound(name, shape):
    fi, fo = J._fans(shape)
    return {"fan_in_uniform": 1 / math.sqrt(max(1, fi)),
            "xavier_uniform": math.sqrt(6 / (fi + fo)),
            "uniform": 0.05}[name]


def _normal_std(name, shape):
    fi, fo = J._fans(shape)
    return {"xavier_normal": math.sqrt(2 / (fi + fo)),
            "msra_normal": math.sqrt(2 / max(1, fi)),
            "lecun_normal": math.sqrt(1 / max(1, fi)),
            "normal": 0.02}[name]


def _inits(m, name):
    return {"uniform": m.uniform(0.05), "normal": m.normal(0.02, 0.0)}.get(
        name) or getattr(m, name)


@pytest.mark.parametrize("shape", BIG)
@pytest.mark.parametrize("name", ["fan_in_uniform", "xavier_uniform",
                                  "uniform"])
def test_uniform_bounds_and_stds(name, shape):
    s = _uniform_bound(name, shape)
    for got in (_port(_inits(T, name), shape).numpy(),
                _jax(_inits(J, name), shape)):
        assert np.abs(got).max() <= s
        assert np.abs(got).max() >= 0.98 * s
        assert abs(got.std() / (s / math.sqrt(3)) - 1) < 0.03
        assert abs(got.mean()) < 0.03 * s


@pytest.mark.parametrize("shape", BIG)
@pytest.mark.parametrize("name", ["xavier_normal", "msra_normal",
                                  "lecun_normal", "normal"])
def test_normal_stds(name, shape):
    sd = _normal_std(name, shape)
    for got in (_port(_inits(T, name), shape).numpy(),
                _jax(_inits(J, name), shape)):
        assert abs(got.std() / sd - 1) < 0.03
        assert abs(got.mean()) < 0.03 * sd


@pytest.mark.parametrize("shape", [(64, 32), (32, 64), (4, 8, 16),
                                   (3, 3, 8, 16)])
@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_orthogonal_is_scaled_orthonormal(shape, scale):
    rows, cols = math.prod(shape[:-1]), shape[-1]
    for got in (_port(T.orthogonal(scale), shape).numpy(),
                _jax(J.orthogonal(scale), shape)):
        assert got.shape == shape
        m = got.reshape(rows, cols)
        g = m.T @ m if rows >= cols else m @ m.T
        np.testing.assert_allclose(g, scale ** 2 * np.eye(min(rows, cols)),
                                   atol=1e-5)
    # a vector takes normal(0.01), as in JAX
    v = _port(T.orthogonal(), (4096,)).numpy()
    assert abs(v.std() / 0.01 - 1) < 0.05


def _set(param, array):
    with torch.no_grad():
        param.copy_(torch.from_numpy(np.array(array)))


def test_linear_without_bias_and_with_an_init_matches_jax(nprng):
    x = nprng.randn(3, 5, 16).astype(np.float32)
    jl = JLinear(24, act="tanh", use_bias=False, w_init=J.xavier_normal)
    vs = jl.init(jax.random.PRNGKey(0), jnp.asarray(x))
    (p,) = vs["params"].values()
    assert set(p) == {"w"}
    tl = Linear(16, 24, act="tanh", use_bias=False, w_init=T.xavier_normal,
                device="cpu", generator=torch.Generator().manual_seed(0))
    assert tl.b is None and [n for n, _ in tl.named_parameters()] == ["w"]
    assert abs(tl.w.std().item() / math.sqrt(2 / 40) - 1) < 0.2
    _set(tl.w, p["w"])
    _close(tl(torch.from_numpy(x)).detach(), jl.apply(vs, jnp.asarray(x)))
    # a bias from b_init
    tb = Linear(16, 24, b_init=T.constant(0.5), device="cpu")
    assert (tb.b == 0.5).all()


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("flash", [False, True])
def test_attention_head_dim_and_out_dim_match_jax(nprng, flash):
    D, H, HD, OUT = 24, 2, 16, 40
    x = nprng.randn(2, 8, D).astype(np.float32)
    jm = JMHA(H, head_dim=HD, out_dim=OUT, use_flash=flash)
    vs = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), causal=True)
    (p,) = vs["params"].values()
    tm = MultiHeadAttention(D, H, use_flash=flash, head_dim=HD, out_dim=OUT,
                            device="cpu")
    assert tm.head_dim == HD
    for name in ("wq", "wk", "wv", "wo"):
        assert tuple(getattr(tm, name).shape) == p[name].shape, name
        _set(getattr(tm, name), p[name])
    assert tuple(tm.wo.shape) == (H * HD, OUT)
    want, (jk, jv) = jm.apply(vs, jnp.asarray(x), causal=True,
                              return_kv=True)
    got, (k, v) = tm(torch.from_numpy(x), causal=True, return_kv=True)
    assert tuple(k.shape) == (2, 8, H, HD)
    _close(got.detach(), want)
    _close(k.detach(), jk)
    _close(v.detach(), jv)
