"""The port's fused LayerNorm-matmul against the JAX package's (f32, CPU):
``paddle_tpu_torch.nn.fused_ln_matmul`` (its plain path on the CPU)
against JAX's ``fused_ln_matmul`` (the Pallas kernel in interpret mode)
and ``ln_matmul_reference`` on the inputs of
``tests/test_autotune.py::test_fused_ln_matmul_matches_reference``, and
the argument checks that make both refuse the same calls.

Tolerance: rtol and atol 1e-5, as the JAX test holds its own kernel to
its reference (f32, the same math rounded in another order)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.nn.fused_ln import fused_ln_matmul as jfused
from paddle_tpu.nn.fused_ln import ln_matmul_reference as jref
from paddle_tpu_torch.nn import fused_ln as fl

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs():
    rng = np.random.RandomState(1)
    return (rng.normal(size=(128, 32)).astype(np.float32),
            rng.normal(size=(32, 256)).astype(np.float32),
            rng.normal(size=(32,)).astype(np.float32),
            rng.normal(size=(32,)).astype(np.float32))


@pytest.mark.parametrize("affine", ["", "s", "sb", "b"])
def test_fused_ln_matmul_matches_jax(affine):
    x, w, scale, bias = _inputs()
    sc = scale if "s" in affine else None
    bi = bias if "b" in affine else None

    def j(a):
        return None if a is None else jnp.asarray(a)

    def t(a):
        return None if a is None else torch.from_numpy(a)

    want_kernel = np.asarray(jfused(j(x), j(w), j(sc), j(bi)))
    want_ref = np.asarray(jref(j(x), j(w), j(sc), j(bi)))
    got = fl.fused_ln_matmul(t(x), t(w), t(sc), t(bi)).numpy()
    np.testing.assert_allclose(got, want_kernel, **TOL)
    np.testing.assert_allclose(got, want_ref, **TOL)
    # explicit dividing blocks give the same result
    got_b = fl.fused_ln_matmul(t(x), t(w), t(sc), t(bi), block_m=64,
                               block_n=128).numpy()
    np.testing.assert_allclose(got_b, want_ref, **TOL)
    np.testing.assert_allclose(
        fl.ln_matmul_reference(t(x), t(w), t(sc), t(bi)).numpy(), want_ref,
        **TOL)


@pytest.mark.parametrize("kw,w_rows", [({"block_m": 48}, 32),
                                       ({"block_n": 100}, 32),
                                       ({"block_m": 96, "block_n": 256}, 32),
                                       ({}, 16)])
def test_fused_ln_matmul_refuses_what_jax_refuses(kw, w_rows):
    x, w, _, _ = _inputs()
    w = w[:w_rows]
    with pytest.raises(AssertionError):
        jfused(jnp.asarray(x), jnp.asarray(w), **kw)
    with pytest.raises(ValueError):
        fl.fused_ln_matmul(torch.from_numpy(x), torch.from_numpy(w), **kw)


def test_auto_block_matches_jax():
    from paddle_tpu.nn.pallas_attention import _auto_block
    for t in (1, 7, 8, 34, 100, 128, 384, 1000, 2048, 6144):
        for cap in (128, 512):
            assert fl._auto_block(t, cap) == _auto_block(t, cap), (t, cap)
