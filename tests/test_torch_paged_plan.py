"""Host-side launch plan of the split-context paged kernels
(``csrc/paged_attention.cuh``) and the merge rule they run. Pure Python
and PyTorch on the CPU:

- the partition ``P`` is a whole number of pool blocks and depends on the
  block size alone: the same for every table width, span length, slot
  count and head count (``hypothesis``), which is what keeps each span row
  bit-equal to the paged decode at its position;
- the partitions cover the table's ``[0, MB * bs)`` exactly;
- the partials kernel's shared memory stays within the 227 KB a block may
  use for D in {64, 128} and bs in {8, 16, 32};
- the workspace holds one 16-byte-aligned record per (slot, row, head,
  partition);
- the merge rule: each row's softmax split into the plan's partitions and
  merged in order against the JAX ``paged_decode_attention`` and
  ``paged_span_attention`` (Pallas interpret mode) at lengths 0, 1,
  ``P - 1``, ``P``, ``P + 1`` and ``MB * bs``, and a partition wholly past
  a row adding exactly 0;
- the bf16 pools' rule (a max pass, every partition's p taken against the
  row's max and rounded to bf16 before ``p . V``, the partitions merged
  with factors of exactly 1) against ``paged_decode_plain`` and
  ``paged_span_plain`` on bf16 pools, which round p against the row's max
  as well, and against JAX's kernels in interpret mode on inputs where
  JAX's running max is the row's max from its first block; both with the
  main pass recomputing the scores from K and with it reading the scores
  the max pass stored (bit-equal to each other);
- the bf16 pools' shared memory: ``paged_smem_bytes`` and ``paged_plan``
  at D 64 and 128, R 1 and 16, pinned to the header's ``Layout``
  arithmetic (written out here) and within a block's 227 KB; the main
  pass's ``PvLayout`` (no K, raw K, query tile or f32 V) the same way, and
  every block size the plan accepts fitting both passes (``hypothesis``);
- the bf16 pools' workspace: the records, the stored scores (a row's
  contiguous and 16-byte aligned), in elements and bytes.

Tolerance of the merge against JAX: 2e-6 (f32 on both sides, summed in
other orders over at most 192 positions), as ``tests/test_torch_span.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from paddle_tpu.nn import pallas_attention as jpa
from paddle_tpu_torch.nn import cuda_attention as ca

ATOL = 2e-6
SMEM_LIMIT = 232448          # 227 KB, a block's dynamic shared memory


@settings(max_examples=200, deadline=None)
@given(bs=st.integers(1, 256), D=st.sampled_from([64, 128]),
       MB=st.integers(1, 512), MB2=st.integers(1, 512),
       Q=st.integers(1, ca.SPAN_MAX_Q), Q2=st.integers(1, ca.SPAN_MAX_Q),
       quant=st.booleans())
def test_partition_depends_on_the_block_size_alone(bs, D, MB, MB2, Q, Q2,
                                                   quant):
    a = ca.paged_plan(MB, bs, D, Q, quant)
    b = ca.paged_plan(MB2, bs, D, Q2, not quant)
    # S and H are not inputs of the plan at all
    assert a.part == b.part
    assert a.part % bs == 0 and a.part >= 128
    assert a.part // bs <= 128               # one table entry per thread
    assert a == ca.paged_plan(MB, bs, D, Q, quant)          # repeatable


@pytest.mark.parametrize("bs,want", [(1, 128), (8, 128), (16, 128),
                                     (32, 128), (64, 128), (12, 132),
                                     (100, 200), (128, 128)])
def test_partition_sizes(bs, want):
    assert ca.paged_plan(64, bs, 64, 1).part == want


@pytest.mark.parametrize("MB,bs", [(1, 16), (8, 16), (9, 16), (64, 16),
                                   (3, 8), (65, 32), (100, 12), (0, 16)])
def test_partitions_cover_the_table(MB, bs):
    plan = ca.paged_plan(MB, bs, 64, 5)
    W = MB * bs
    bounds = [(k * plan.part, min((k + 1) * plan.part, W))
              for k in range(plan.parts)]
    if W == 0:
        assert bounds == []
        return
    assert bounds[0][0] == 0 and bounds[-1][1] == W
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert all(e > b for b, e in bounds)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("bs", [8, 16, 32])
@pytest.mark.parametrize("Q", [1, 5, 128, 256])
@pytest.mark.parametrize("quant", [False, True])
def test_shared_memory_within_a_block(D, bs, Q, quant):
    plan = ca.paged_plan(64, bs, D, Q, quant)
    assert plan.smem <= SMEM_LIMIT
    assert plan.smem % 16 == 0
    # the padded K and plain V of a partition at least
    assert plan.smem >= 4 * plan.part * (2 * D + 4)


def test_row_tile():
    assert ca.paged_plan(64, 16, 64, 1).rows == 1
    for Q, tiles in ((5, 1), (16, 1), (17, 2), (128, 8), (256, 16)):
        plan = ca.paged_plan(64, 16, 64, Q)
        assert plan.rows == 16 and plan.tiles == tiles


def test_oversized_block_is_refused_by_the_plan():
    # the wrappers' "block size too large" refusal
    assert ca.paged_plan(2, 512, 64, 1).smem > SMEM_LIMIT
    assert ca.paged_plan(4, 256, 128, 5, True).smem > SMEM_LIMIT
    assert ca.paged_plan(4, 128, 128, 5, True).smem <= SMEM_LIMIT


@pytest.mark.parametrize("S,Q,H,D,MB,bs", [(8, 1, 8, 64, 64, 16),
                                           (1, 128, 8, 64, 64, 16),
                                           (3, 5, 2, 128, 9, 8)])
def test_workspace_shape(S, Q, H, D, MB, bs):
    plan = ca.paged_plan(MB, bs, D, Q)
    shape = plan.workspace_shape(S, H)
    assert shape == (S, Q, H, -(-MB * bs // plan.part), D + 4)
    assert (4 * shape[-1]) % 16 == 0          # float4 records


# ---------------------------------------------------------------------------
# the merge rule
# ---------------------------------------------------------------------------

def _partials(q, k, v, pos, P, parts, scale, bf16=False, stored=False):
    """Per-partition ``(m, l, acc)`` of each row: ``q [R, D]``, ``k, v
    [R, W, D]`` (each row's context in position order), ``pos [R]``; the
    kernel's conventions (running max from -1e30, -inf past the row).
    With ``bf16`` the bf16 pools' two passes: a max pass gives each row's
    partition maxima, every partition takes m = their max over the
    partitions the row reaches, and p enters ``p . V`` rounded to bf16
    (l sums the unrounded p). With ``stored`` the max pass also writes
    each partition's scores into a workspace of rows ``part`` rounded up
    to 4 floats (NaN where it writes nothing), and the main pass takes
    its scores from there alone."""
    W = k.shape[1]
    s = torch.einsum("rd,rwd->rw", q, k) * scale
    s = s.masked_fill(torch.arange(W)[None] > pos[:, None], float("-inf"))
    maxima = [s[:, kk * P:(kk + 1) * P].amax(-1).clamp_min(-1e30)
              for kk in range(parts)]
    if stored:
        buf = torch.full((s.shape[0], parts, -(-P // 4) * 4), float("nan"))
        for kk in range(parts):
            n = min(P, W - kk * P)
            buf[:, kk, :n] = s[:, kk * P:kk * P + n]
        s = None                  # the main pass computes no score
    if bf16:
        K = torch.clamp(pos, max=W - 1) // P + 1
        M = torch.full_like(maxima[0], -1e30)
        for kk, mk in enumerate(maxima):
            M = torch.where(kk < K, torch.maximum(M, mk), M)
    out = []
    for kk in range(parts):
        sl = slice(kk * P, min((kk + 1) * P, W))
        m = M if bf16 else maxima[kk]
        sk = buf[:, kk, :sl.stop - sl.start] if stored else s[:, sl]
        p = torch.exp(sk - m[:, None])
        pr = p.bfloat16().float() if bf16 else p
        out.append((m, p.sum(-1), torch.einsum("rw,rwd->rd", pr, v[:, sl])))
    return out


def _merge(partials, K):
    """Row r merges its first ``K[r]`` partials in order; ``max(l,
    1e-30)``."""
    R, D = partials[0][2].shape
    M = torch.full((R,), -float("inf"))
    for kk, (m, _, _) in enumerate(partials):
        M = torch.where(kk < K, torch.maximum(M, m), M)
    l = torch.zeros(R)
    acc = torch.zeros(R, D)
    for kk, (m, lk, ak) in enumerate(partials):
        f = torch.where(kk < K, torch.exp(m - M), torch.zeros(R))
        l = l + f * lk
        acc = acc + f[:, None] * ak
    return acc / l.clamp_min(1e-30)[:, None]


def _split_attention(q, pk, pv, tables, pos, live, P, stored=False):
    """``[S, Q, H, D]`` by the kernels' two launches (three over bf16
    pools): ``q [S, Q, H, D]``, ``pos [S, Q]`` each row's position,
    ``live [S, Q]``; ``stored`` as :func:`_partials`."""
    S, Q, H, D = q.shape
    bs = pk.shape[1]
    W = tables.shape[1] * bs
    bf16 = pk.dtype == torch.bfloat16
    k = pk[tables.long()].reshape(S, W, H, D).float()
    v = pv[tables.long()].reshape(S, W, H, D).float()
    parts = -(-W // P)
    rq = q.permute(0, 2, 1, 3).reshape(-1, D)                 # [S*H*Q, D]
    rk = k.permute(0, 2, 1, 3)[:, :, None].expand(S, H, Q, W, D) \
        .reshape(-1, W, D)
    rv = v.permute(0, 2, 1, 3)[:, :, None].expand(S, H, Q, W, D) \
        .reshape(-1, W, D)
    rpos = pos[:, None].expand(S, H, Q).reshape(-1)
    partials = _partials(rq, rk, rv, rpos, P, parts, D ** -0.5, bf16,
                         stored)
    K = torch.clamp(rpos, max=W - 1) // P + 1
    out = _merge(partials, K)
    # a partition wholly past a row adds exactly 0
    assert torch.equal(_merge(partials, torch.full_like(K, parts)), out)
    out = out.reshape(S, H, Q, D).permute(0, 2, 1, 3)
    return out * live[..., None, None]


def _pools(rng, S, H, D, bs, MB):
    N = S * MB + 1
    pk = rng.randn(N, bs, H, D).astype(np.float32)
    pv = rng.randn(N, bs, H, D).astype(np.float32)
    tables = (1 + rng.permutation(N - 1)[:S * MB]).reshape(S, MB) \
        .astype(np.int32)
    return pk, pv, tables


def test_split_merge_matches_jax_paged_decode():
    S, H, D, bs, MB = 6, 2, 16, 16, 12
    P = ca.paged_plan(MB, bs, D, 1).part
    assert P == 128 and MB * bs == 192
    rng = np.random.RandomState(0)
    pk, pv, tables = _pools(rng, S, H, D, bs, MB)
    lengths = np.array([0, 1, P - 1, P, P + 1, MB * bs], np.int32)
    q = rng.randn(S, H, D).astype(np.float32)
    want = np.asarray(jpa.paged_decode_attention(
        *(jnp.asarray(a) for a in (q, pk, pv, tables, lengths))))
    t = torch.from_numpy
    got = _split_attention(t(q)[:, None], t(pk), t(pv), t(tables),
                           t(lengths)[:, None].long() - 1,
                           t(lengths)[:, None] > 0, P)[:, 0]
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert not got[0].any()
    plain = ca.paged_decode_plain(t(q), t(pk), t(pv), t(tables), t(lengths))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL,
                               rtol=0)


def test_split_merge_matches_jax_paged_span():
    """Spans ending at, starting at and crossing a partition boundary,
    one filling the table, one inactive."""
    S, H, D, bs, MB, Q = 5, 2, 16, 16, 12, 5
    P = ca.paged_plan(MB, bs, D, Q).part
    rng = np.random.RandomState(1)
    pk, pv, tables = _pools(rng, S, H, D, bs, MB)
    start = np.array([P - Q, P, P - 2, MB * bs - Q, 7], np.int32)
    n = np.array([Q, Q, Q, Q, 0], np.int32)
    q = rng.randn(S, Q, H, D).astype(np.float32)
    want = np.asarray(jpa.paged_span_attention(
        *(jnp.asarray(a) for a in (q, pk, pv, tables, start, n))))
    t = torch.from_numpy
    pos = t(start)[:, None].long() + torch.arange(Q)[None]
    live = torch.arange(Q)[None] < t(n)[:, None]
    got = _split_attention(t(q), t(pk), t(pv), t(tables), pos, live, P)
    for s in range(S):
        np.testing.assert_allclose(got[s, :n[s]].numpy(), want[s, :n[s]],
                                   atol=ATOL, rtol=0)
    assert not got[4].any()


# ---------------------------------------------------------------------------
# bf16 pools
# ---------------------------------------------------------------------------

def _layout_total(D, R, P, pool):
    """``paged::Layout(D, R, P, pool).total`` of csrc/paged_attention.cuh,
    field by field."""
    up16 = lambda b: -(-b // 16) * 16                      # noqa: E731
    eb = {ca.POOL_F32: 0, ca.POOL_INT8: 1, ca.POOL_BF16: 2}[pool]
    quant = pool == ca.POOL_INT8
    vs = 4 * P * (D + 4)
    qs = vs + 4 * P * D
    ss = qs + 4 * R * D
    st = up16(ss + 4 * R * P)
    kraw = up16(st + 8 * R + 4 * 128)
    ksc = kraw + 2 * eb * P * D
    vsc = up16(ksc + (4 * P if quant else 0))
    return up16(vsc + (4 * P if quant else 0))


@pytest.mark.parametrize("D,R,want", [(64, 1, 101648), (64, 16, 113280),
                                      (128, 1, 200208), (128, 16, 215680)])
def test_bf16_pool_shared_memory(D, R, want):
    """Both raw bf16 partitions staged beside the f32 layout: 2 * 2 * P *
    D bytes more (65,536 at D 128), within the 232,448 a block may use."""
    Q = 1 if R == 1 else 5
    plan = ca.paged_plan(64, 16, D, Q, ca.POOL_BF16)
    assert plan.rows == R and plan.part == 128
    assert plan.smem == ca.paged_smem_bytes(D, R, 128, ca.POOL_BF16) \
        == _layout_total(D, R, 128, ca.POOL_BF16) == want
    assert want <= SMEM_LIMIT
    assert want - ca.paged_plan(64, 16, D, Q).smem == 4 * 128 * D
    for pool in (ca.POOL_F32, ca.POOL_INT8):
        assert ca.paged_smem_bytes(D, R, 128, pool) == \
            _layout_total(D, R, 128, pool)


def _pv_layout_total(D, R, P):
    """``paged::PvLayout(D, R, P).total``, the bf16 pools' main pass, field
    by field: the stored scores (rows of P rounded up to 4 floats), the row
    state and pool blocks, the raw bf16 V rows."""
    up16 = lambda b: -(-b // 16) * 16                      # noqa: E731
    st = up16(4 * R * (-(-P // 4) * 4))
    vraw = up16(st + 8 * R + 4 * 128)
    return up16(vraw + 2 * P * D)


@pytest.mark.parametrize("D,R,want", [(64, 1, 17424), (64, 16, 25216),
                                      (128, 1, 33808), (128, 16, 41600)])
def test_bf16_main_pass_shared_memory(D, R, want):
    """The main pass stages no K, raw K or query tile, and widens V in
    registers: a sixth to a fifth of the max pass's bytes at D 128, whose
    layout (every pool's ``Layout``) stays as it was."""
    Q = 1 if R == 1 else 5
    plan = ca.paged_plan(64, 16, D, Q, ca.POOL_BF16)
    assert plan.rows == R and plan.part == 128
    assert plan.pv_smem == ca.paged_pv_smem_bytes(D, R, 128) \
        == _pv_layout_total(D, R, 128) == want
    assert plan.smem == _layout_total(D, R, 128, ca.POOL_BF16)
    # the max pass's K, raw K and query tile are what the main pass drops
    assert plan.smem - plan.pv_smem >= 4 * 128 * (D + 4) + 2 * 128 * D \
        + 4 * R * D
    for pool in (ca.POOL_F32, ca.POOL_INT8):
        assert ca.paged_plan(64, 16, D, Q, pool).pv_smem == 0


@settings(max_examples=200, deadline=None)
@given(bs=st.integers(1, 256), D=st.sampled_from([64, 128]),
       Q=st.integers(1, ca.SPAN_MAX_Q))
def test_bf16_accepted_block_sizes_fit_both_passes(bs, D, Q):
    """Which block sizes the plan accepts over bf16 pools is decided by
    the max pass's layout, as before the main pass had its own; the main
    pass fits wherever the max pass does, in fewer bytes."""
    plan = ca.paged_plan(64, bs, D, Q, ca.POOL_BF16)
    assert plan.smem == _layout_total(D, plan.rows, plan.part, ca.POOL_BF16)
    assert plan.pv_smem == _pv_layout_total(D, plan.rows, plan.part)
    assert plan.pv_smem % 16 == 0 and plan.pv_smem < plan.smem
    if plan.smem <= SMEM_LIMIT:
        assert plan.pv_smem <= SMEM_LIMIT


@pytest.mark.parametrize("S,Q,H,D,MB,bs,mib", [
    (8, 1, 8, 64, 64, 16, 0.25),         # the serving decode, W 1024
    (1, 128, 8, 64, 64, 16, 4),          # a 128-row chunk
    (8, ca.SPAN_MAX_Q, 8, 128, 64, 16, 64),   # the largest span
    (3, 5, 2, 64, 9, 7, None)])          # P 133: rows padded to 136
def test_bf16_scores_workspace(S, Q, H, D, MB, bs, mib):
    """Over bf16 pools the workspace holds the records, then the max
    pass's scores; a row's scores over a partition are contiguous and
    16-byte aligned, and so is where the scores start. Other pools
    allocate nothing new."""
    plan = ca.paged_plan(MB, bs, D, Q, ca.POOL_BF16)
    rec = plan.workspace_shape(S, H)
    sc = plan.scores_shape(S, H)
    assert sc == (S, Q, H, plan.parts, -(-plan.part // 4) * 4)
    assert (4 * sc[-1]) % 16 == 0 and (4 * np.prod(rec)) % 16 == 0
    if mib is not None:
        assert 4 * np.prod(sc) == mib * 2 ** 20
    assert plan.workspace_numel(S, H) == np.prod(rec) + np.prod(sc)
    for pool in (ca.POOL_F32, ca.POOL_INT8):
        other = ca.paged_plan(MB, bs, D, Q, pool)
        assert np.prod(other.scores_shape(S, H)) == 0
        assert other.workspace_numel(S, H) == np.prod(rec)


def test_bf16_plan_refuses_what_does_not_fit():
    # bs 100 puts 200 positions in a partition: fits f32 at D 128, not bf16
    assert ca.paged_plan(4, 100, 128, 1).smem <= SMEM_LIMIT
    assert ca.paged_plan(4, 100, 128, 1, ca.POOL_BF16).smem > SMEM_LIMIT


def _max_at_position_zero(q, pk, tables, alpha=3.0):
    """Set each slot's key at position 0 to ``alpha`` times its (every
    row's) query, rounded to bf16: every row's max score then lies at
    position 0, in JAX's first pool block. ``q [S, Q, H, D]`` with its Q
    rows equal."""
    first = tables[:, 0].long()
    pk[first, 0] = (alpha * q[:, 0]).bfloat16()


@pytest.mark.parametrize("stored", [False, True],
                         ids=["recompute", "stored_scores"])
def test_bf16_two_pass_rule_matches_the_plain_versions(stored):
    """The bf16 pools' rule at ATOL against the plain versions; then
    against JAX's ``paged_decode_attention`` and ``paged_span_attention``
    (interpret mode). JAX rounds p against a running max per pool block,
    which is the row's final max from its first block on exactly when
    the row's max lies in that block: those inputs put it at position 0
    (each slot's Q rows share one query; the row then sums to its key's
    value, up to 2.5 here, so the bound is ATOL of max(1, max |JAX|), as
    chip_smoke.py scales its own), the others are general. With
    ``stored`` the main pass reads the max pass's scores and must equal
    the recomputing rule bit for bit."""
    S, H, D, bs, MB, Q = 6, 2, 16, 16, 12, 5
    P = ca.paged_plan(MB, bs, D, 1, ca.POOL_BF16).part
    rng = np.random.RandomState(2)
    pk, pv, tables = _pools(rng, S, H, D, bs, MB)
    t = torch.from_numpy
    pk, pv, tables = t(pk).bfloat16(), t(pv).bfloat16(), t(tables)
    lengths = t(np.array([0, 1, P - 1, P, P + 1, MB * bs], np.int32))
    q = t(rng.randn(S, Q, H, D).astype(np.float32))
    dec_pos, dec_live = lengths[:, None].long() - 1, lengths[:, None] > 0
    start = t(np.array([P - Q, P, P - 2, MB * bs - Q, 7, 0], np.int32))
    n = t(np.array([Q, Q, Q, Q, 0, 3], np.int32))
    pos = start[:, None].long() + torch.arange(Q)[None]
    live = torch.arange(Q)[None] < n[:, None]

    def both(q, pk):
        dec = _split_attention(q[:, :1], pk, pv, tables, dec_pos, dec_live,
                               P, stored)[:, 0]
        span = _split_attention(q, pk, pv, tables, pos, live, P, stored)
        if stored:
            assert torch.equal(dec, _split_attention(
                q[:, :1], pk, pv, tables, dec_pos, dec_live, P)[:, 0])
            assert torch.equal(span, _split_attention(q, pk, pv, tables,
                                                      pos, live, P))
        return dec, span

    dec, span = both(q, pk)
    want = ca.paged_decode_plain(q[:, 0].contiguous(), pk, pv, tables,
                                 lengths)
    np.testing.assert_allclose(dec.numpy(), want.numpy(), atol=ATOL, rtol=0)
    want = ca.paged_span_plain(q, pk, pv, tables, start, n)
    np.testing.assert_allclose(span[live].numpy(), want[live].numpy(),
                               atol=ATOL, rtol=0)

    q = q[:, :1].expand(S, Q, H, D).contiguous()
    pk = pk.clone()
    _max_at_position_zero(q, pk, tables)
    dec, span = both(q, pk)
    j = lambda a: jnp.asarray(a.float().numpy()).astype(  # noqa: E731
        jnp.bfloat16 if a.dtype == torch.bfloat16 else a.numpy().dtype)
    want = np.asarray(jpa.paged_decode_attention(
        *(j(a) for a in (q[:, 0].contiguous(), pk, pv, tables, lengths))))
    np.testing.assert_allclose(dec.numpy(), want, rtol=0,
                               atol=ATOL * max(1.0, np.abs(want).max()))
    want = np.asarray(jpa.paged_span_attention(
        *(j(a) for a in (q, pk, pv, tables, start, n))))[live.numpy()]
    np.testing.assert_allclose(span[live].numpy(), want, rtol=0,
                               atol=ATOL * max(1.0, np.abs(want).max()))
