"""The port's attention kernels' plain versions against the JAX Pallas
kernels (run in interpret mode on the CPU, as tests/test_pallas_attention.py
runs them), on the same inputs. Tolerance: atol 1e-5 — f32 throughout, the
blockwise online softmax and the whole-row softmax sum in different
orders. On CPU tensors the wrappers run the plain versions and count no
kernel launch."""

import pathlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.nn import pallas_attention as jpa
from paddle_tpu_torch.nn import cuda_attention as ca
from paddle_tpu_torch.utils import cuda_build

ATOL = 1e-5


def _segments(B, T):
    """Packed ids with a padding tail: row b holds two sequences, 0s after."""
    seg = np.zeros((B, T), np.int32)
    for b in range(B):
        a, c = T // 2 - 8 * b, T - 8 - 4 * b
        seg[b, :a], seg[b, a:c] = 1, 2
    return seg


@pytest.mark.parametrize("causal,with_segments", [(True, False),
                                                  (False, True),
                                                  (True, True)])
def test_flash_plain_matches_jax_kernel(causal, with_segments, nprng):
    B, H, T, D = 2, 2, 64, 16
    q, k, v = (nprng.randn(B, H, T, D).astype(np.float32) for _ in range(3))
    seg = _segments(B, T) if with_segments else None
    # small JAX blocks so its causal and segment block skips are exercised
    out_j, lse_j = jpa._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if seg is None else jnp.asarray(seg), causal, D ** -0.5, 16,
        16, True)
    ca.reset_launch_counts()
    out_t, lse_t = ca.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if seg is None else torch.from_numpy(seg), causal)
    assert ca.launch_counts()["flash_fwd"] == 0
    live = np.ones((B, T), bool) if seg is None else seg > 0
    # padding rows are unspecified in the JAX kernel; the port writes 0s
    ot = out_t.numpy().transpose(0, 2, 1, 3)           # [B, T, H, D]
    oj = np.asarray(out_j).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(ot[live], oj[live], atol=ATOL, rtol=0)
    lt = lse_t.numpy().transpose(0, 2, 1)               # [B, T, H]
    lj = np.asarray(lse_j).transpose(0, 2, 1)
    np.testing.assert_allclose(lt[live], lj[live], atol=ATOL, rtol=0)
    assert not ot[~live].any() and (lt[~live] < -1e29).all()
    # the public no-LSE entry is the same computation
    ref = jpa.reference_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  segments=None if seg is None
                                  else jnp.asarray(seg))
    got = ca.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v),
                             None if seg is None else torch.from_numpy(seg),
                             causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


def _paged_case(nprng, S=5, H=2, D=16, bs=4, MB=6, N=24):
    lengths = np.array([0, 1, 4, 5, MB * bs][:S], np.int32)
    perm = nprng.permutation(np.arange(1, N))
    tables = np.zeros((S, MB), np.int32)
    used = 0
    for s, L in enumerate(lengths):
        nb = -(-int(L) // bs)
        tables[s, :nb] = perm[used:used + nb]
        used += nb
    tables[3, :1] = tables[4, :1]              # slots 3 and 4 share a block
    q = nprng.randn(S, H, D).astype(np.float32)
    pk = nprng.randn(N, bs, H, D).astype(np.float32)
    pv = nprng.randn(N, bs, H, D).astype(np.float32)
    return q, pk, pv, tables, lengths


def test_paged_plain_matches_jax_kernel(nprng):
    q, pk, pv, tables, lengths = _paged_case(nprng)
    want = np.asarray(jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(tables), jnp.asarray(lengths), interpret=True))
    oracle = np.asarray(jpa.paged_reference_attention(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(tables), jnp.asarray(lengths)))
    ca.reset_launch_counts()
    got = ca.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(pk), torch.from_numpy(pv),
        torch.from_numpy(tables), torch.from_numpy(lengths)).numpy()
    assert ca.launch_counts()["paged_decode"] == 0
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, oracle, atol=ATOL, rtol=0)
    assert not got[0].any()                    # length 0 -> zeros


def test_paged_wrapper_rejects_quantized_pools(nprng):
    q, pk, pv, tables, lengths = (torch.from_numpy(a)
                                  for a in _paged_case(nprng))
    # int8 pools come as (values, scales) for both K and V, never mixed
    with pytest.raises(ValueError, match="both be plain"):
        ca.paged_decode_attention(q, (pk, pk[..., 0]), pv, tables, lengths)
    with pytest.raises(ValueError, match="both be plain"):
        ca.paged_span_attention(q[:, None], pk, (pv, pv[..., 0]), tables,
                                lengths, lengths)


def test_wrappers_refuse_devices_without_a_kernel():
    q = torch.zeros(1, 1, 8, 64, device="meta")
    with pytest.raises(ValueError):
        ca.flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError):
        ca.paged_decode_attention(torch.zeros(1, 1, 64, device="meta"),
                                  q[0], q[0], None, None)


def test_kernel_sources_named_by_the_wrappers_exist():
    """Every kernel the wrappers launch has its CUDA source, C entry point
    and note of the TPU kernel it replaces; CPU runs load no library."""
    csrc = pathlib.Path(ca.__file__).resolve().parents[1] / "csrc"
    for name, stem in ca.KERNELS.items():
        src = (csrc / f"{stem}.cu").read_text()
        assert f'extern "C" int {name}_f32(' in src
        assert "paddle_tpu/nn/pallas_attention.py" in src
    assert not cuda_build._loaded
