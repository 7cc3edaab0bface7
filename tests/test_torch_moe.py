"""The port's MoEFFN against the JAX layer on the same weights and inputs
(f32, CPU): outputs, the Switch aux loss, the routing stats (drop rate,
expert fractions, capacity) and the gradients of the input and of every
parameter (autograd against ``jax.grad``), at top_k 1 and 2, with and
without renormalized gates, at capacity factors that drop tokens and at
one that drops none. Also ties between router probabilities (the lower
expert first, as ``jax.lax.top_k``), and a bf16 input against JAX's
promotion. Tolerance: atol 2e-5 on values and gradients, the same f32
ops summed in other orders; the routing (which pairs are kept, in which
slot) must be identical, so the drop rate and the per-expert
first-choice counts are equal exactly."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.nn.moe import MoEFFN as JMoEFFN
from paddle_tpu_torch.nn.moe import MoEFFN

B, T, D, E, H = 2, 12, 16, 4, 24
ATOL = 2e-5


def _pair(top_k, renormalize, factor, seed=0):
    x = np.random.RandomState(seed).randn(B, T, D).astype(np.float32)
    jm = JMoEFFN(E, H, capacity_factor=factor, top_k=top_k,
                 renormalize=renormalize)
    vs = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    (p,) = vs["params"].values()
    # non-zero biases, so their gradients and broadcasts are exercised
    rs = np.random.RandomState(seed + 1)
    p["b1"] = jnp.asarray(rs.randn(E, H).astype(np.float32) * 0.1)
    p["b2"] = jnp.asarray(rs.randn(E, D).astype(np.float32) * 0.1)
    tm = MoEFFN(D, E, H, capacity_factor=factor, top_k=top_k,
                renormalize=renormalize, device="cpu")
    with torch.no_grad():
        for name, arr in p.items():
            getattr(tm, name).copy_(torch.from_numpy(np.array(arr)))
    return x, jm, vs, tm


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=0)


def _same_fraction(got, want):
    """Equal first-choice counts per expert (the means are the counts over
    N, rounded after sums in other orders)."""
    n = B * T
    np.testing.assert_array_equal(np.rint(got.numpy() * n),
                                  np.rint(np.asarray(want) * n))
    _close(got, want, 1e-7)


CASES = [(1, True, 1.25), (1, True, 0.5), (2, True, 1.0), (2, False, 0.75),
         (2, True, 4.0)]


@pytest.mark.parametrize("top_k,renormalize,factor", CASES)
def test_forward_aux_and_stats_match_jax(top_k, renormalize, factor):
    x, jm, vs, tm = _pair(top_k, renormalize, factor)
    jout, jaux, jst = jm.apply(vs, jnp.asarray(x), return_aux=True,
                               return_stats=True)
    out, aux, st = tm(torch.from_numpy(x), return_aux=True,
                      return_stats=True)
    _close(out.detach(), jout)
    _close(aux.detach(), jaux, 1e-6)
    assert float(st["drop_rate"]) == float(jst["drop_rate"])
    _same_fraction(st["expert_fraction"], jst["expert_fraction"])
    assert int(st["capacity"]) == int(jst["capacity"]) == tm.capacity(B * T)
    assert st["capacity"].dtype == torch.int32
    if factor < 1.0:
        assert float(st["drop_rate"]) > 0        # drops happen here
    if factor == 4.0:
        assert float(st["drop_rate"]) == 0.0
    # the single-output forms
    _close(tm(torch.from_numpy(x)).detach(), jout)
    o2, s2 = tm(torch.from_numpy(x), return_stats=True)
    assert float(s2["drop_rate"]) == float(jst["drop_rate"])


@pytest.mark.parametrize("top_k,renormalize,factor", CASES)
def test_gradients_match_jax(top_k, renormalize, factor):
    x, jm, vs, tm = _pair(top_k, renormalize, factor, seed=3)
    g = np.random.RandomState(9).randn(B, T, D).astype(np.float32)

    def jloss(params, xx):
        out, aux = jm.apply({"params": params, "state": {}}, xx,
                            return_aux=True)
        return jnp.sum(out * g) + 0.3 * aux

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(vs["params"],
                                                  jnp.asarray(x))
    (jg_p,) = jg_p.values()
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = tm(xt, return_aux=True)
    ((out * torch.from_numpy(g)).sum() + 0.3 * aux).backward()
    _close(xt.grad, jg_x)
    for name, want in jg_p.items():
        got = getattr(tm, name).grad
        assert got is not None, name
        _close(got, want)
    # the router is trained through the gates (and the aux loss)
    assert float(np.abs(np.asarray(jg_p["wg"])).max()) > 0


def test_probability_ties_take_the_lower_expert_first():
    """A zero router gives every token equal probabilities: JAX's top_k
    takes experts 0, 1, ... in order, and so must the port."""
    x, jm, vs, tm = _pair(2, True, 1.0)
    (p,) = vs["params"].values()
    p["wg"] = jnp.zeros_like(p["wg"])
    with torch.no_grad():
        tm.wg.zero_()
    jout, jst = jm.apply(vs, jnp.asarray(x), return_stats=True)
    out, st = tm(torch.from_numpy(x), return_stats=True)
    _close(out.detach(), jout)
    _same_fraction(st["expert_fraction"], jst["expert_fraction"])
    np.testing.assert_array_equal(st["expert_fraction"].numpy(),
                                  [1.0, 0.0, 0.0, 0.0])
    assert float(st["drop_rate"]) == float(jst["drop_rate"])


def test_bf16_input_follows_jax_promotion():
    """A bf16 ``x`` keeps its dispatch and combine tensors in bf16, and
    each product takes the dtype ``jnp`` promotes its operands to (f32
    against the f32 weights), as the JAX layer computes it."""
    x, jm, vs, tm = _pair(1, True, 1.25)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    jout = jm.apply(vs, xb)
    out = tm(torch.from_numpy(np.array(xb.astype(jnp.float32))).to(
        torch.bfloat16))
    assert out.dtype == torch.float32 and jout.dtype == jnp.float32
    _close(out.detach(), jout, 1e-2)


def test_initial_distributions_and_refusals():
    g = torch.Generator().manual_seed(0)
    m = MoEFFN(64, 8, 256, device="cpu", generator=g)
    # JAX's fans: w1 [E, D, H] has fan_in D * E, w2 [E, H, D] H * E
    assert m.w1.abs().max() <= 1 / np.sqrt(64 * 8)
    assert m.w2.abs().max() <= 1 / np.sqrt(256 * 8)
    assert m.wg.abs().max() <= np.sqrt(6 / (64 + 8))
    assert not m.b1.any() and not m.b2.any()
    with pytest.raises(ValueError):
        MoEFFN(8, 4, 8, top_k=5, device="cpu")
