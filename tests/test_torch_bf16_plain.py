"""The attention kernels' plain versions on bf16 operands against the JAX
Pallas kernels in interpret mode (CPU), on the same numpy inputs from a
seed: ``flash_attention_plain``, ``flash_bwd_dq_plain``,
``flash_bwd_dkv_plain``, ``paged_decode_plain`` and ``paged_span_plain``.
The JAX kernels round p (and ds) to the other operand's dtype before the
second product (``pallas_attention.py``: p to v at ``:151``, ``:631``,
``:763``; ds to k at ``:199``; p to dO and ds to q at ``:243``, ``:249``),
and so do the plain versions. Without that rounding about a third of the
bf16 outputs land one ulp away from JAX's; with it, none or almost none.

Tolerances, each with its reason:

- where JAX's softmax sees the whole row at once (the forward and the
  paged kernels with one key block, and the backward, which takes the
  saved LSE): every entry within one bf16 ulp of the output's largest
  entry (``|port - jax| <= 2^-7 max |jax|``) and at most 1% of the
  entries off at all. Both sum the same exact bf16 products in f32 in
  other orders, and their exponentials may differ in the last f32 bit, so
  a p or an output can round to the neighbouring bf16 value where it
  straddles a rounding boundary; an entry near zero (a sum that cancels)
  then moves by more than its own ulp, never by more than one of the
  largest. The unrounded p puts 30-40% of the entries off.
- where JAX's online softmax spans several key blocks: every entry within
  one bf16 ulp of the largest, nothing more. JAX rounds ``exp(s - m)``
  with the running maximum of the blocks seen so far and rescales the sum
  later; the plain version rounds it with the row's own maximum, so where
  the two maxima differ the rounded p differ by a rounding of their own.

With f32 operands the rounding is a no-op: the five functions' outputs
are bit for bit those of the unrounded formula."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.nn import pallas_attention as jpa
from paddle_tpu_torch.nn import cuda_attention as ca

ULP = 2.0 ** -7
OFF_SHARE = 0.01


def _bf(a):
    return jnp.asarray(a, jnp.bfloat16)


def _tb(a):
    return torch.from_numpy(a).bfloat16()


def _check(got, want, whole_row=True, live=None):
    """``got`` (torch) against ``want`` (JAX), both bf16, as the module's
    docstring says."""
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    if live is not None:
        g, w = g[live], w[live]
    d = np.abs(g - w)
    assert d.max() <= ULP * np.abs(w).max(), d.max()
    if whole_row:
        assert (d > 0).mean() <= OFF_SHARE, (d > 0).mean()


def _flash_inputs(seed, B=1, H=2, T=64, D=64):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, T, D).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("causal,block_k,whole_row", [
    (True, 64, True), (False, 64, True), (True, 16, False)])
def test_flash_plain_rounds_p_as_jax(causal, block_k, whole_row):
    q, k, v, _ = _flash_inputs(0)
    scale = q.shape[-1] ** -0.5
    out_j, lse_j = jpa._flash_forward(_bf(q), _bf(k), _bf(v), None, causal,
                                      scale, 16, block_k, True)
    out_t, lse_t = ca.flash_attention_plain(_tb(q), _tb(k), _tb(v), None,
                                            causal, scale)
    assert out_t.dtype == torch.bfloat16
    _check(out_t, out_j, whole_row)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("causal,block", [(True, 16), (False, 64)])
def test_flash_bwd_plains_round_ds_and_p_as_jax(causal, block):
    q, k, v, do = _flash_inputs(1)
    scale = q.shape[-1] ** -0.5
    o, lse = jpa._flash_forward(_bf(q), _bf(k), _bf(v), None, causal,
                                scale, block, block, True)
    dq_j, dk_j, dv_j = jpa._flash_backward(
        _bf(q), _bf(k), _bf(v), None, o, lse, _bf(do), causal, scale, block,
        block, True)
    # JAX's delta: rowsum(dO * O) in f32 of the bf16 dO and O
    delta = torch.from_numpy(np.sum(np.asarray(_bf(do), np.float32)
                                    * np.asarray(o, np.float32), -1))
    lse_t = torch.from_numpy(np.array(lse))
    dq = ca.flash_bwd_dq_plain(_tb(q), _tb(k), _tb(v), None, _tb(do), lse_t,
                               delta, causal, scale)
    dk, dv = ca.flash_bwd_dkv_plain(_tb(q), _tb(k), _tb(v), None, _tb(do),
                                    lse_t, delta, causal, scale)
    for got, want in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        assert got.dtype == torch.bfloat16
        _check(got, want)


def _paged_inputs(seed, bs, MB, S=4, H=2, D=64, Q=5):
    rng = np.random.RandomState(seed)
    tables = (1 + rng.permutation(S * MB)).reshape(S, MB).astype(np.int32)
    lengths = np.array([0, 5, bs * MB - 3, bs * MB], np.int32)
    pk, pv = (rng.randn(S * MB + 1, bs, H, D).astype(np.float32)
              for _ in range(2))
    q = rng.randn(S, H, D).astype(np.float32)
    qs = rng.randn(S, Q, H, D).astype(np.float32)
    start = np.array([0, 3, bs * MB - 8, 2], np.int32)
    n = np.array([0, 5, 5, 3], np.int32)
    return q, qs, pk, pv, tables, lengths, start, n


@pytest.mark.parametrize("bs,MB,whole_row", [(64, 1, True),
                                             (16, 4, False)])
def test_paged_plains_round_p_as_jax(bs, MB, whole_row):
    q, qs, pk, pv, tables, lengths, start, n = _paged_inputs(2, bs, MB)
    want = jpa.paged_decode_attention(
        _bf(q), _bf(pk), _bf(pv), jnp.asarray(tables), jnp.asarray(lengths),
        interpret=True)
    got = ca.paged_decode_plain(_tb(q), _tb(pk), _tb(pv),
                                torch.from_numpy(tables),
                                torch.from_numpy(lengths))
    assert got.dtype == torch.bfloat16
    _check(got, want, whole_row)
    want = jpa.paged_span_attention(
        _bf(qs), _bf(pk), _bf(pv), jnp.asarray(tables), jnp.asarray(start),
        jnp.asarray(n), interpret=True)
    got = ca.paged_span_plain(_tb(qs), _tb(pk), _tb(pv),
                              torch.from_numpy(tables),
                              torch.from_numpy(start), torch.from_numpy(n))
    live = np.arange(qs.shape[1])[None] < n[:, None]    # rows >= n: padding
    _check(got, want, whole_row, live)


def _int8_pool(a):
    scales = np.abs(a).max(-1) / 127 + 1e-3
    vals = np.clip(np.round(a / scales[..., None]), -127, 127)
    return vals.astype(np.int8), scales.astype(np.float32)


def test_int8_pools_take_p_unrounded():
    # JAX dequantizes an int8 pool to f32 before p . V, so p stays f32
    q, _, pk, pv, tables, lengths, _, _ = _paged_inputs(3, 16, 2)
    pool_k, pool_v = _int8_pool(pk), _int8_pool(pv)
    want = jpa.paged_decode_attention(
        jnp.asarray(q), tuple(map(jnp.asarray, pool_k)),
        tuple(map(jnp.asarray, pool_v)), jnp.asarray(tables),
        jnp.asarray(lengths), interpret=True)
    got = ca.paged_decode_plain(
        torch.from_numpy(q), tuple(map(torch.from_numpy, pool_k)),
        tuple(map(torch.from_numpy, pool_v)), torch.from_numpy(tables),
        torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def _all_five(q, k, v, do, qp, pk, pv, tables, lengths, qs, start, n):
    out, lse = ca.flash_attention_plain(q, k, v, None, True)
    delta = (out * do).sum(-1)
    return [out, lse,
            ca.flash_bwd_dq_plain(q, k, v, None, do, lse, delta, True),
            *ca.flash_bwd_dkv_plain(q, k, v, None, do, lse, delta, True),
            ca.paged_decode_plain(qp, pk, pv, tables, lengths),
            ca.paged_span_plain(qs, pk, pv, tables, start, n)]


def test_f32_outputs_are_those_of_the_unrounded_formula(monkeypatch):
    flash = [torch.from_numpy(a) for a in _flash_inputs(4, T=48)]
    paged = [torch.from_numpy(a) for a in _paged_inputs(5, 16, 4)]
    qp, qs, pk, pv, tables, lengths, start, n = paged
    args = (*flash, qp, pk, pv, tables, lengths, qs, start, n)
    rounded = _all_five(*args)
    monkeypatch.setattr(ca, "_rounded", lambda p, dtype: p)
    unrounded = _all_five(*args)
    for a, b in zip(rounded, unrounded):
        assert a.dtype == torch.float32 and torch.equal(a, b)
