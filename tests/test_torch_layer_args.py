"""The layer arguments the port took from the JAX layers (f32, CPU):
``LayerNorm(eps, use_scale, use_bias)``, ``Embedding(w_init)`` and
``Conv2D(w_init)``, each against the JAX layer on the same weights and
inputs. A constant ``w_init`` gives the JAX table bit for bit; a random
one (the frameworks' generators differ) is held to its distribution and
then compared on bridged weights. Tolerance: atol 1e-6 (the same f32
ops, summed in another order)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.core import initializers as JI
from paddle_tpu.nn.layers import Conv2D as JConv2D
from paddle_tpu.nn.layers import Embedding as JEmbedding
from paddle_tpu.nn.layers import LayerNorm as JLayerNorm
from paddle_tpu_torch.core import initializers as TI
from paddle_tpu_torch.nn.layers import Conv2D, Embedding, LayerNorm

ATOL = 1e-6


def _set(param, array):
    with torch.no_grad():
        param.copy_(torch.from_numpy(np.array(array)))


@pytest.mark.parametrize("eps,use_scale,use_bias", [
    (1e-6, True, True), (1e-3, True, True), (1e-5, False, True),
    (1e-6, True, False), (0.5, False, False)])
def test_layernorm_arguments_match_jax(eps, use_scale, use_bias, nprng):
    x = (1e-2 * nprng.randn(3, 4, 32)).astype(np.float32)
    jn = JLayerNorm(eps=eps, use_scale=use_scale, use_bias=use_bias)
    vs = jn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tn = LayerNorm(32, eps=eps, use_scale=use_scale, use_bias=use_bias,
                   device="cpu")
    p = next(iter(vs["params"].values()), {}) if vs.get("params") else {}
    assert sorted(n for n, _ in tn.named_parameters()) == sorted(p)
    if use_scale:
        p["scale"] = jnp.asarray(1 + nprng.randn(32).astype(np.float32))
        _set(tn.scale, p["scale"])
    if use_bias:
        p["bias"] = jnp.asarray(nprng.randn(32).astype(np.float32))
        _set(tn.bias, p["bias"])
    want = np.asarray(jn.apply(vs, jnp.asarray(x)))
    got = tn(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL * 10, rtol=1e-5)
    if not (use_scale or use_bias):
        assert list(tn.parameters()) == []
    bf = tn(torch.from_numpy(x).bfloat16())
    assert bf.dtype == torch.bfloat16


@pytest.mark.parametrize("which", ["constant", "normal", "uniform"])
def test_embedding_w_init_matches_jax(which, nprng):
    jinit, tinit = {
        "constant": (JI.constant(0.25), TI.constant(0.25)),
        "normal": (JI.normal(0.02), TI.normal(0.02)),
        "uniform": (JI.uniform(0.1), TI.uniform(0.1)),
    }[which]
    ids = np.array([[0, 3, 9, -1, 511, 57]], np.int32)
    je = JEmbedding(512, 64, w_init=jinit)
    vs = je.init(jax.random.PRNGKey(0), jnp.asarray(ids))
    (p,) = vs["params"].values()
    te = Embedding(512, 64, w_init=tinit, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    jw, tw = np.asarray(p["w"]), te.w.detach().numpy()
    if which == "constant":
        np.testing.assert_array_equal(tw, jw)
    elif which == "normal":
        assert abs(tw.std() - 0.02) < 1e-3 and abs(jw.std() - 0.02) < 1e-3
        assert abs(tw.mean()) < 1e-3
    else:
        assert np.abs(tw).max() <= 0.1 and np.abs(jw).max() <= 0.1
        assert abs(tw.std() - 0.1 / np.sqrt(3)) < 2e-3
    _set(te.w, jw)
    got = te(torch.from_numpy(ids).long()).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(je.apply(vs, ids)),
                               atol=ATOL, rtol=0)
    default = Embedding(512, 64, device="cpu")
    assert abs(default.w.detach().numpy().std() - 1 / 8) < 5e-3


@pytest.mark.parametrize("which", ["constant", "xavier_uniform",
                                   "msra_default"])
def test_conv2d_w_init_matches_jax(which, nprng):
    x = nprng.randn(2, 9, 9, 6).astype(np.float32)
    jkw, tkw = {
        "constant": ({"w_init": JI.constant(0.03)},
                     {"w_init": TI.constant(0.03)}),
        "xavier_uniform": ({"w_init": JI.xavier_uniform},
                           {"w_init": TI.xavier_uniform}),
        "msra_default": ({}, {}),
    }[which]
    jc = JConv2D(8, 3, stride=2, **jkw)
    vs = jc.init(jax.random.PRNGKey(0), jnp.asarray(x))
    (p,) = vs["params"].values()
    tc = Conv2D(6, 8, 3, stride=2, device="cpu",
                generator=torch.Generator().manual_seed(0), **tkw)
    jw, tw = np.asarray(p["w"]), tc.w.detach().numpy()
    assert tw.shape == jw.shape == (3, 3, 6, 8)
    if which == "constant":
        np.testing.assert_array_equal(tw, jw)
    else:
        fan_in, fan_out = 3 * 3 * 6, 3 * 3 * 8
        std = (np.sqrt(2.0 / (fan_in + fan_out)) if which == "xavier_uniform"
               else np.sqrt(2.0 / fan_in))
        for w in (tw, jw):
            assert 0.75 * std < w.std() < 1.25 * std, which
    _set(tc.w, jw)
    _set(tc.b, nprng.randn(8).astype(np.float32))
    p["b"] = jnp.asarray(tc.b.detach().numpy())
    want = np.asarray(jc.apply(vs, jnp.asarray(x)))
    got = tc(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
