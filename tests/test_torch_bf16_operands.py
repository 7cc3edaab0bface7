"""The port's flash attention and fused LayerNorm-matmul on bf16 operands
against the JAX package on the CPU, on the same seeded numpy inputs: the
port's ``flash_attention`` under autograd (``FlashAttentionFunction``:
its plain forward and backward on CPU tensors) against ``jax.vjp`` of
JAX's ``flash_attention`` (the Pallas kernels in interpret mode, at JAX's
default blocks unless a case names its own), and ``fused_ln_matmul``
against JAX's. On the card the same calls launch ``flash_fwd_bf16``,
``flash_bwd_dq_bf16``, ``flash_bwd_dkv_bf16`` and ``ln_matmul_bf16``,
which ``tests/test_torch_cuda_kernels.py`` holds against these plain
versions. Also the bf16 copy width the flash wrappers read off pointers.

Tolerances, each with its reason:

- flash at JAX's default blocks (T <= 1024: one key block, so JAX rounds
  p against the row's whole max, as the port does; the backward takes the
  saved LSE): every entry of O, dq, dk and dv within one bf16 ulp of the
  tensor's largest entry (``|port - jax| <= 2^-7 max |jax|``) and at most
  1% of the entries off at all. Both sum the same exact bf16 products in
  f32 in other orders and their exponentials may differ in the last f32
  bit, so a p, a ds or an output can round to the neighbouring bf16 value
  where it straddles a rounding boundary; an entry near zero then moves
  by more than its own ulp, never by more than one of the largest. O is
  compared on live rows: JAX leaves padding rows unspecified, the port
  writes zeros. dO is zero on padding rows, as the model's label -1 makes
  it.
- the JAX test's own case (``tests/test_pallas_attention.py``:
  ``[1, 1, 128, 16]``, causal, blocks of 64): one ulp of the largest
  alone. JAX's online softmax there rounds ``exp(s - m)`` with the running
  max of two key blocks and rescales later, the port against the row's
  own max, so more entries land an ulp apart (16-28% of them, measured at
  blocks of 64).
- ``fused_ln_matmul``: one ulp of the largest entry, at most 1% off (bit
  for bit equal in the runs this file was written against: the same f32
  statistics, the same rounding of y, one f32 sum of exact products)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.nn import pallas_attention as jpa
from paddle_tpu.nn.fused_ln import fused_ln_matmul as jfused
from paddle_tpu_torch.nn import cuda_attention as ca
from paddle_tpu_torch.nn import fused_ln as fl

ULP = 2.0 ** -7
OFF_SHARE = 0.01


def _bf(a):
    return jnp.asarray(a, jnp.bfloat16)


def _tb(a):
    return torch.from_numpy(np.ascontiguousarray(a)).bfloat16()


def _segments(B, T):
    """Two packed sequences a row and a padding tail."""
    seg = np.zeros((B, T), np.int32)
    for b in range(B):
        a, c = T // 2 - 8 * b, T - 8 - 4 * b
        seg[b, :a], seg[b, a:c] = 1, 2
    return seg


def _check(got, want, whole_row=True, live=None):
    """``got`` (torch, bf16) against ``want`` (JAX, bf16), as the module's
    docstring says; ``live`` selects the rows ``[B, T]`` compared."""
    assert got.dtype == torch.bfloat16
    assert want.dtype == jnp.bfloat16
    g = got.detach().float().numpy()
    w = np.asarray(want, np.float32)
    if live is not None:
        g = g.transpose(0, 2, 1, 3)[live]
        w = w.transpose(0, 2, 1, 3)[live]
    d = np.abs(g - w)
    assert d.max() <= ULP * np.abs(w).max(), (d.max(), np.abs(w).max())
    if whole_row:
        assert (d > 0).mean() <= OFF_SHARE, (d > 0).mean()


def _flash_case(seed, B, H, T, D, causal, segs, blocks=(None, None),
                whole_row=True):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(B, H, T, D).astype(np.float32)
                   for _ in range(4))
    seg = _segments(B, T) if segs else None
    if seg is not None:
        do = do * (seg > 0)[:, None, :, None]
    bq, bk = jpa._blocks(*blocks, T)
    seg_j = None if seg is None else jnp.asarray(seg)

    def f(q, k, v):
        return jpa.flash_attention(q, k, v, seg_j, causal, None, bq, bk,
                                   True)

    out_j, vjp = jax.vjp(f, _bf(q), _bf(k), _bf(v))
    grads_j = vjp(_bf(do))

    qt, kt, vt = (_tb(a).requires_grad_() for a in (q, k, v))
    ca.reset_launch_counts()
    out_t = ca.flash_attention(qt, kt, vt, None if seg is None
                               else torch.from_numpy(seg), causal)
    assert type(out_t.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    out_t.backward(_tb(do))
    assert not any(ca.launch_counts().values())    # CPU: plain versions
    live = None if seg is None else seg > 0
    _check(out_t, out_j, whole_row, live)
    for t, g in zip((qt, kt, vt), grads_j):
        _check(t.grad, g, whole_row)


@pytest.mark.parametrize("B,H,T,D,causal,segs", [
    (1, 2, 128, 64, True, False), (1, 2, 256, 64, False, False),
    (1, 2, 256, 64, True, True), (1, 2, 128, 128, False, True),
    (2, 2, 256, 128, True, True), (1, 1, 256, 128, True, False),
    (2, 1, 192, 64, False, True), (1, 2, 160, 128, True, False),
])
def test_flash_bf16_autograd_matches_jax_vjp(B, H, T, D, causal, segs):
    _flash_case(T + D, B, H, T, D, causal, segs)


@pytest.mark.parametrize("seed", [0, 1])
def test_flash_bf16_jax_test_case_within_one_ulp(seed):
    """``test_flash_bf16_forward_backward``'s shape and blocks."""
    _flash_case(seed, 1, 1, 128, 16, True, False, blocks=(64, 64),
                whole_row=False)


@pytest.mark.parametrize("affine", ["", "s", "b", "sb"])
@pytest.mark.parametrize("affine_dtype", [np.float32, "bfloat16"])
def test_fused_ln_matmul_bf16_matches_jax(affine, affine_dtype):
    rng = np.random.RandomState(len(affine))
    x = (rng.randn(128, 64) * 3 + 1).astype(np.float32)
    w = (rng.randn(64, 256) / 8).astype(np.float32)
    sc = (1 + 0.3 * rng.randn(64)).astype(np.float32) \
        if "s" in affine else None
    bi = (0.3 * rng.randn(64)).astype(np.float32) if "b" in affine else None

    def j(a):
        if a is None:
            return None
        return _bf(a) if affine_dtype == "bfloat16" else jnp.asarray(a)

    def t(a):
        if a is None:
            return None
        a = torch.from_numpy(a)
        return a.bfloat16() if affine_dtype == "bfloat16" else a

    want = jfused(_bf(x), _bf(w), j(sc), j(bi))
    fl.reset_launch_counts()
    got = fl.fused_ln_matmul(_tb(x), _tb(w), t(sc), t(bi))
    assert not any(fl.launch_counts().values())
    _check(got[None, None], want[None, None])


@pytest.mark.parametrize("offset,width", [(0, 8), (8, 8), (2, 2), (6, 2),
                                          (1, 0), (3, 0)])
def test_flash_bf16_copy_width_reads_the_pointers(offset, width):
    """16-byte copies where every bf16 operand is 16-byte aligned, 4-byte
    ones where they are 4-byte aligned, none (the wrappers refuse) at 2
    bytes off 4; float32 operands keep their widths, 4 and 1."""
    buf = torch.zeros(2 * 64 * 64 + 16, dtype=torch.bfloat16)
    view = buf[offset:offset + 2 * 64 * 64].view(1, 2, 64, 64)
    fresh = torch.zeros(1, 2, 64, 64, dtype=torch.bfloat16)
    assert ca.flash_copy_width(view, fresh) == width
    assert ca.flash_copy_width(fresh, fresh) == 8
    f32 = torch.zeros(2 * 64 * 64 + 4)
    assert ca.flash_copy_width(f32[1:1 + 2 * 64 * 64].view(1, 2, 64, 64)) == 1
    assert ca.flash_copy_width(f32[4:4 + 2 * 64 * 64].view(1, 2, 64, 64)) == 4
