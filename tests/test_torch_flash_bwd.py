"""The port's flash-attention backward on CPU tensors — the plain backward
reached through ``FlashAttentionFunction`` — against the JAX Pallas
backward ``_flash_backward`` (interpret mode, ``block_q = block_k = 16``
so its causal and segment block skips run) and against ``jax.grad`` of
``reference_attention``, on the same inputs. Tolerance: atol 1e-5 — f32
throughout, blockwise and whole-row sums in different orders.

Convention for padding rows (segment id 0): the upstream gradient dO is
zero there. The JAX kernel masks with -1e30, so a padding row's
probabilities come out as 1 and feed dk/dv from any non-zero dO on that
row, where the port (masking with -inf) gives p = 0. With dO zero on
padding rows the two agree, and in the model it always is zero: label -1
masks those rows out of the loss.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.nn import pallas_attention as jpa
from paddle_tpu_torch.nn import cuda_attention as ca

ATOL = 1e-5
B, H, T, D = 2, 2, 64, 16


def _segments():
    """Two packed sequences per row and a padding tail."""
    seg = np.zeros((B, T), np.int32)
    for b in range(B):
        a, c = T // 2 - 8 * b, T - 8 - 4 * b
        seg[b, :a], seg[b, a:c] = 1, 2
    return seg


def _inputs(seed, with_segments):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(B, H, T, D).astype(np.float32)
                   for _ in range(4))
    seg = _segments() if with_segments else None
    if seg is not None:
        do = do * (seg > 0)[:, None, :, None]
    return q, k, v, do, seg


def _port_grads(q, k, v, do, seg, causal):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ca.flash_attention(qt, kt, vt,
                             None if seg is None else torch.from_numpy(seg),
                             causal)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    out.backward(torch.from_numpy(do))
    return [t.grad.numpy() for t in (qt, kt, vt)]


CASES = [(True, False), (False, True), (True, True)]


@pytest.mark.parametrize("causal,with_segments", CASES)
def test_backward_matches_jax_kernel(causal, with_segments):
    q, k, v, do, seg = _inputs(0, with_segments)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    jseg = None if seg is None else jnp.asarray(seg)
    out, lse = jpa._flash_forward(jq, jk, jv, jseg, causal, D ** -0.5, 16,
                                  16, True)
    want = jpa._flash_backward(jq, jk, jv, jseg, out, lse, jdo, causal,
                               D ** -0.5, 16, 16, True)
    ca.reset_launch_counts()
    got = _port_grads(q, k, v, do, seg, causal)
    assert not any(ca.launch_counts().values())
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=0,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal,with_segments", CASES)
def test_backward_matches_grad_of_reference_attention(causal,
                                                      with_segments):
    q, k, v, do, seg = _inputs(1, with_segments)
    jseg = None if seg is None else jnp.asarray(seg)

    def f(q, k, v):
        o = jpa.reference_attention(q, k, v, causal=causal, segments=jseg)
        return jnp.sum(o * jnp.asarray(do))

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                             for a in (q, k, v)))
    got = _port_grads(q, k, v, do, seg, causal)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=0,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal,with_segments", CASES)
def test_bwd_wrapper_is_the_two_kernels_plain_versions(causal,
                                                       with_segments):
    """``flash_attention_bwd`` on CPU tensors equals ``flash_bwd_dq`` and
    ``flash_bwd_dkv`` fed the forward's LSE and ``rowsum(dO * O)`` —
    the split the card runs — and padding rows get zero gradients."""
    q, k, v, do, seg = (None if a is None else torch.from_numpy(a)
                        for a in _inputs(2, with_segments))
    o, lse = ca.flash_attention_fwd(q, k, v, seg, causal)
    dq, dk, dv = ca.flash_attention_bwd(q, k, v, seg, o, lse, do, causal)
    delta = (do * o).sum(-1)
    dq2 = ca.flash_bwd_dq(q, k, v, seg, do, lse, delta, causal)
    dk2, dv2 = ca.flash_bwd_dkv(q, k, v, seg, do, lse, delta, causal)
    for a, b in ((dq, dq2), (dk, dk2), (dv, dv2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, rtol=0)
    if seg is not None:
        pad = (seg == 0)[:, None, :, None].expand_as(dq)
        assert not dq[pad].any() and not dk[pad].any() \
            and not dv[pad].any()


def test_no_grad_saves_nothing_and_grad_mode_needs_a_grad_input():
    q, k, v, _, _ = (None if a is None else torch.from_numpy(a)
                     for a in _inputs(3, False))
    with torch.no_grad():
        out = ca.flash_attention(q.requires_grad_(), k, v, None, True)
    assert out.grad_fn is None
    q.requires_grad_(False)
    assert ca.flash_attention(q, k, v, None, True).grad_fn is None
    want, _ = ca.flash_attention_fwd(q, k, v, None, True)
    assert torch.equal(out, want)


def test_bwd_wrappers_refuse_devices_without_a_kernel():
    q = torch.zeros(1, 1, 8, 64, device="meta")
    r = torch.zeros(1, 1, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ca.flash_attention_bwd(q, q, q, None, q, r, q)
    with pytest.raises(ValueError, match="no kernel"):
        ca.flash_bwd_dq(q, q, q, None, q, r, r)
    with pytest.raises(ValueError, match="no kernel"):
        ca.flash_bwd_dkv(q, q, q, None, q, r, r)
