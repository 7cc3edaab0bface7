"""The flash-attention backward kernels' host side on the CPU: the launch
plan (``flash_bwd_plan``: shared memory, cover, determinism, a full wave
at the main path's shapes), the tile schedule the two kernels walk under
the plan's instances (the causal bounds and segment-range skips of
``csrc/flash_bwd.cu``, written out here in Python, as a ``hypothesis``
property against the visibility it must keep), and the split-TF32
algebra of the kernels' products (``rna_tf32`` on float32 bits with
integer ops, three products with ``lo.lo`` dropped, partial sums per
32-wide chunk of the contraction, or per streamed tile) against the JAX
``_flash_backward`` in interpret mode. Tolerance of the algebra: atol
1e-5, the tolerance of the port's backward against JAX
(``test_torch_flash_bwd.py``): f32 throughout, sums in other orders. The
tensor cores' truncating adds cannot be emulated here; the card tests
hold them. The bf16 instances (``flash_bwd_dq_bf16``,
``flash_bwd_dkv_bf16``): their plan and the bf16 ds they store."""

from collections import Counter

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from paddle_tpu.nn import pallas_attention as jpa
from paddle_tpu_torch.nn import cuda_attention as ca

ATOL = 1e-5
MAX_SMEM = 232448          # dynamic shared memory a block may opt into
SM_SMEM = 233472           # an SM's shared memory; 1 KB reserved a block
INT_MAX, INT_MIN = 2 ** 31 - 1, -2 ** 31


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [64, 128])
def test_every_instance_fits_its_shared_memory(D):
    for t in ca._BWD_TILES[D]:
        smem = ca._bwd_smem(D, t)
        assert smem <= MAX_SMEM
        assert t.blocks_per_sm * (smem + 1024) <= SM_SMEM
        assert t.rows % 16 == 0 and t.stream_rows in (16, 32)
        assert t.stages >= 2


@pytest.mark.parametrize("B,H,T,D", [
    (1, 1, 1, 64), (1, 1, 15, 128), (2, 3, 33, 64), (8, 4, 2048, 128),
    (2, 8, 512, 128), (1, 8, 1024, 64), (3, 3, 1000, 128), (1, 2, 2047, 64),
    (7, 5, 4097, 128)])
def test_plan_covers_t_and_depends_on_the_shape_alone(B, H, T, D):
    plan = ca.flash_bwd_plan(B, H, T, D, True)
    assert plan.tiles * plan.rows >= T > (plan.tiles - 1) * plan.rows
    assert plan.grid == B * H * plan.tiles
    assert plan.warps * 8 == plan.rows           # 16 rows a pair
    t = ca._BWD_TILES[D][plan.tile]
    assert (plan.rows, plan.stream_rows, plan.stages, plan.blocks_per_sm) \
        == tuple(t)
    assert plan.smem == ca._bwd_smem(D, t) <= MAX_SMEM
    assert ca.flash_bwd_plan(B, H, T, D, True) == plan
    assert ca.flash_bwd_plan(B, H, T, D, False) == plan
    assert plan.stored_ds == (T % 4 == 0
                              and 4 * B * H * T * T <= ca._DS_BUDGET)


@pytest.mark.parametrize("shape,tile", [((8, 4, 2048, 128), 0),
                                        ((2, 8, 512, 128), 1)])
def test_main_path_shapes_fill_a_wave(shape, tile):
    """The training shape takes the large instance (1024 blocks); the
    segments shape would give 128 large blocks, under one wave of 132
    SMs, so it takes the small one (256)."""
    plan = ca.flash_bwd_plan(*shape, True)
    assert plan.tile == tile
    assert plan.grid >= ca._SMS
    assert plan.stored_ds          # 512 MiB and 16 MiB of ds


@pytest.mark.parametrize("shape,stored", [
    ((8, 4, 2048, 128), True),     # the training shape: 512 MiB
    ((16, 4, 2048, 128), True),    # the budget exactly: 1 GiB
    ((17, 4, 2048, 128), False),   # one batch row past it
    ((8, 4, 2900, 128), False),    # a longer T past it
    ((8, 4, 2046, 128), False),    # ds rows not 16-byte multiples
    ((2, 8, 512, 64), True), ((1, 1, 1, 64), False)])
def test_stored_ds_is_chosen_by_the_budget(shape, stored):
    """ds is stored by one rule, the same on both sides of the budget:
    ``T`` a multiple of 4 and the ``[B * H, T, T]`` f32 buffer within
    1 GiB, the rise in a step's peak memory the buffer may cost."""
    assert ca._DS_BUDGET == 2 ** 30
    assert ca.flash_bwd_plan(*shape, True).stored_ds is stored


# ---------------------------------------------------------------------------
# the tile schedule of csrc/flash_bwd.cu
# ---------------------------------------------------------------------------

def _seg_range(seg, row0, n, T):
    """``seg_range``: (min, max) id over rows [row0, row0 + n) below T."""
    ids = seg[row0:min(row0 + n, T)]
    return (int(ids.min()), int(ids.max())) if len(ids) else (INT_MAX,
                                                              INT_MIN)


def _meet(a, b):
    """``seg_meet`` (``_seg_block_relevant``)."""
    return a[0] <= b[1] and a[1] >= b[0] and a[1] > 0 and b[1] > 0


def _visits(kernel, seg, T, causal, rows, bs):
    """``{(block tile, streamed tile): visits}`` of one kernel: dq's
    blocks own query rows and stream key tiles, dk/dv's the reverse; and
    the (block, tile, warp) triples whose products a warp skips."""
    n_st = -(-T // bs)
    visits, skipped = Counter(), set()
    for blk in range(-(-T // rows)):
        r0 = blk * rows
        if kernel == "dq":
            first = 0
            end = min((r0 + rows - 1) // bs + 1, n_st) if causal else n_st
        else:
            first, end = (r0 // bs if causal else 0), n_st
        own = None if seg is None else _seg_range(seg, r0, rows, T)
        for t in range(first, end):                       # next_tile
            if seg is not None and not _meet(own, _seg_range(seg, t * bs,
                                                             bs, T)):
                continue
            visits[blk, t] += 1
            for w in range(rows // 16):
                w0 = r0 + 16 * w
                if kernel == "dq":
                    skip = w0 >= T or (causal and t * bs > w0 + 15)
                else:
                    skip = w0 >= T or (causal and t * bs + bs - 1 < w0)
                if skip:
                    skipped.add((blk, t, w))
    return visits, skipped


def _visible(seg, T, causal):
    """``[query, key]`` visibility the kernels must keep."""
    vis = np.ones((T, T), bool)
    if causal:
        vis = np.tril(vis)
    if seg is not None:
        vis &= (seg[:, None] == seg[None, :]) & (seg[:, None] > 0)
    return vis


@st.composite
def _cases(draw):
    T = draw(st.integers(1, 300))
    causal = draw(st.booleans())
    seg = None
    if draw(st.booleans()):
        seg = np.zeros(T, np.int32)
        pos, sid = 0, 1
        tail = draw(st.integers(0, T // 3))              # padding tail
        while pos < T - tail:
            n = draw(st.integers(1, 120))
            seg[pos:min(pos + n, T - tail)] = sid
            pos, sid = pos + n, sid + 1
    return T, causal, seg


@settings(max_examples=60, deadline=None)
@given(_cases(), st.sampled_from([64, 128]))
def test_each_kernel_visits_every_visible_tile_pair_once(case, D):
    T, causal, seg = case
    vis = _visible(seg, T, causal)
    for t in ca._BWD_TILES[D]:
        for kernel in ("dq", "dkv"):
            visits, skipped = _visits(kernel, seg, T, causal, t.rows,
                                      t.stream_rows)
            assert max(visits.values(), default=1) == 1
            # (own rows, streamed rows) of a pair as (query, key) slices
            for blk in range(-(-T // t.rows)):
                own = slice(blk * t.rows, (blk + 1) * t.rows)
                for s in range(-(-T // t.stream_rows)):
                    other = slice(s * t.stream_rows,
                                  (s + 1) * t.stream_rows)
                    pair = vis[own, other] if kernel == "dq" \
                        else vis[other, own]
                    # a pair with a visible pair once; a skipped one none
                    assert visits[blk, s] == 1 if pair.any() \
                        else visits[blk, s] <= 1
            for blk, s, w in skipped:
                rows = slice(blk * t.rows + 16 * w, blk * t.rows + 16 * w
                             + 16)
                other = slice(s * t.stream_rows, (s + 1) * t.stream_rows)
                pair = vis[rows, other] if kernel == "dq" \
                    else vis[other, rows]
                assert not pair.any()
            if kernel == "dkv":
                # stored ds: dk/dv writes ds[q][k] of every visible pair,
                # so dq, which reads only visible entries, never reads one
                # it left unwritten
                for q, k in zip(*np.nonzero(vis)):
                    blk, s = k // t.rows, q // t.stream_rows
                    assert visits[blk, s] == 1
                    assert (blk, s, k % t.rows // 16) not in skipped


def test_schedule_skips_what_segments_rule_out():
    """The property's counterpart: packed segments do cut tiles (the
    schedule is not the full grid)."""
    seg = np.array([1] * 40 + [2] * 40 + [3] * 40 + [0] * 8, np.int32)
    visits, _ = _visits("dq", seg, 128, False, 32, 16)
    assert len(visits) < 4 * 8
    # ids (1, 1) against (3, 3); (2, 3) against (1, 1)
    assert (0, 5) not in visits and (2, 0) not in visits


# ---------------------------------------------------------------------------
# the split-TF32 algebra
# ---------------------------------------------------------------------------

def rna_tf32(x):
    """``tf32_rna``: float32 rounded to TF32's 10 mantissa bits, to nearest
    with ties away from zero, on the bits: add 0x1000, clear 13 bits."""
    b = np.asarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(
        np.float32)


def _split(x):
    hi = rna_tf32(x)
    return hi, rna_tf32((x - hi).astype(np.float32))


def _mm3(a, b, chunk):
    """``a @ b`` over the last axis of a as the kernels take it: each
    operand split into hi and lo, three products (``lo.hi + hi.lo +
    hi.hi``, ``lo.lo`` dropped) summed exactly over each chunk of the
    contraction, each chunk's partial rounded to f32 and added to an f32
    accumulator in order."""
    ah, al = _split(a)
    bh, bl = _split(b)
    f8 = np.float64
    acc = None
    for c in range(0, a.shape[-1], chunk):
        k = slice(c, c + chunk)
        part = (al[..., k].astype(f8) @ bh[..., k, :].astype(f8)
                + ah[..., k].astype(f8) @ bl[..., k, :].astype(f8)
                + ah[..., k].astype(f8) @ bh[..., k, :].astype(f8)
                ).astype(np.float32)
        acc = part if acc is None else (acc + part).astype(np.float32)
    return acc


def test_rna_tf32_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)                 # TF32's ulp at 1
    x = np.array([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -20,
                  1 + 3 * ulp / 2], np.float32)
    np.testing.assert_array_equal(
        rna_tf32(x), np.array([one + ulp, -(one + ulp), one, one + 2 * ulp],
                              np.float32))
    v = np.random.RandomState(0).randn(1000).astype(np.float32)
    hi, lo = _split(v)
    assert not (hi.view(np.uint32) & 0x1fff).any()
    assert not (lo.view(np.uint32) & 0x1fff).any()
    # hi + lo keeps 22 significant bits: the residue is under 2^-21 |v|
    assert (np.abs(v - hi - lo) <= 2.0 ** -21 * np.abs(v)).all()


def _kernel_backward(q, k, v, do, lse, delta, seg, causal, scale, bs):
    """(dq, dk, dv) as the two kernels form them: scores over D in
    partials of 32, ``p = exp(s * scale - LSE)`` (masked pairs -inf),
    ``ds = p * (dp - delta)``, the accumulating products in one partial a
    streamed tile of ``bs`` rows, the scale applied at the end."""
    T = q.shape[2]
    kt = np.swapaxes(k, -1, -2)
    s = _mm3(q, kt, 32)
    dp = _mm3(do, np.swapaxes(v, -1, -2), 32)
    vis = np.broadcast_to(np.tril(np.ones((T, T), bool)) if causal
                          else np.ones((T, T), bool), s.shape)
    if seg is not None:
        vis = vis & ((seg[:, :, None] == seg[:, None, :])
                     & (seg[:, :, None] > 0))[:, None]
    sc = np.where(vis, s * np.float32(scale), np.float32(-np.inf))
    p = np.exp(sc - lse[..., None]).astype(np.float32)
    ds = (p * (dp - delta[..., None])).astype(np.float32)
    dq = _mm3(ds, k, bs) * np.float32(scale)
    dk = _mm3(np.swapaxes(ds, -1, -2), q, bs) * np.float32(scale)
    dv = _mm3(np.swapaxes(p, -1, -2), do, bs)
    return dq, dk, dv


def _packed(B, T):
    """Two packed sequences a row and a padding tail."""
    seg = np.zeros((B, T), np.int32)
    for b in range(B):
        a, c = T // 2 - 8 * b, T - 8 - 4 * b
        seg[b, :a], seg[b, a:c] = 1, 2
    return seg


@pytest.mark.parametrize("shape", [(2, 2, 64, 16), (1, 2, 64, 64)])
@pytest.mark.parametrize("causal,with_segments", [(True, False),
                                                  (False, True),
                                                  (True, True)])
def test_split_tf32_backward_matches_jax(shape, causal, with_segments):
    B, H, T, D = shape
    rng = np.random.RandomState(7)
    q, k, v, do = (rng.randn(*shape).astype(np.float32) for _ in range(4))
    seg = _packed(B, T) if with_segments else None
    if seg is not None:
        do = do * (seg > 0)[:, None, :, None]
    scale = D ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    jseg = None if seg is None else jnp.asarray(seg)
    out, lse = jpa._flash_forward(jq, jk, jv, jseg, causal, scale, 16, 16,
                                  True)
    want = jpa._flash_backward(jq, jk, jv, jseg, out, lse, jdo, causal,
                               scale, 16, 16, True)
    delta = (do * np.asarray(out)).sum(-1, dtype=np.float32)
    bs = ca.flash_bwd_plan(B, H, T, max(D, 64), causal).stream_rows
    got = _kernel_backward(q, k, v, do, np.asarray(lse, np.float32), delta,
                           seg, causal, scale, bs)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=0,
                                   err_msg=f"d{name}")


# ---------------------------------------------------------------------------
# the bf16 instances (flash_bwd_dq_bf16, flash_bwd_dkv_bf16)
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16


@pytest.mark.parametrize("D", [64, 128])
def test_bf16_instances_fit_their_shared_memory(D):
    """No resident planes (each warp's fragments of its one resident
    operand live in registers): per stage two bf16 matrices of pitch
    D + 8 and three f32 vectors, and the pairs' f32 exchange."""
    for t in ca._BWD_TILES_BF16[D]:
        smem = ca._bwd_smem(D, t, BF16)
        assert smem == 4 * (t.stages * (t.stream_rows * (D + 8)
                                        + 3 * t.stream_rows)
                            + t.rows // 8 * 16 * t.stream_rows)
        assert smem <= MAX_SMEM
        assert t.blocks_per_sm * (smem + 1024) <= SM_SMEM
        assert t.rows % 16 == 0 and t.stream_rows in (16, 32)
        assert t.stages >= 2
    assert ca._bwd_tiles(BF16) is ca._BWD_TILES_BF16


@pytest.mark.parametrize("B,H,T,D", [
    (1, 1, 1, 64), (1, 1, 15, 128), (2, 3, 33, 64), (8, 4, 2048, 128),
    (2, 8, 512, 128), (1, 8, 1024, 64), (3, 3, 1000, 128), (1, 2, 2047, 64),
    (7, 5, 4097, 128)])
def test_bf16_plan_covers_t_and_depends_on_the_shape_alone(B, H, T, D):
    """The mma.sync route's plan (4-byte copies, width 2: views 4 bytes
    off 16); the wgmma route's in test_torch_flash_bwd_wgmma_plan.py."""
    plan = ca.flash_bwd_plan(B, H, T, D, True, BF16, 2)
    assert plan.tiles * plan.rows >= T > (plan.tiles - 1) * plan.rows
    assert plan.grid == B * H * plan.tiles
    assert plan.warps * 8 == plan.rows
    t = ca._BWD_TILES_BF16[D][plan.tile]
    assert (plan.rows, plan.stream_rows, plan.stages, plan.blocks_per_sm) \
        == tuple(t)
    assert plan.smem == ca._bwd_smem(D, t, BF16) <= MAX_SMEM
    assert ca.flash_bwd_plan(B, H, T, D, False, BF16, 2) == plan
    assert plan.route == "mma_sync"
    assert plan.stored_ds == (T % 8 == 0
                              and 2 * B * H * T * T <= ca._DS_BUDGET)


@pytest.mark.parametrize("shape,stored", [
    ((8, 4, 2048, 128), True),     # the training shape: 256 MiB
    ((17, 4, 2048, 128), True),    # past the f32 budget, within bf16's
    ((32, 4, 2048, 128), True),    # the budget exactly: 1 GiB
    ((33, 4, 2048, 128), False),   # one batch row past it
    ((8, 4, 2044, 128), False),    # T % 4 == 0 but bf16 rows need T % 8
    ((8, 4, 2040, 128), True), ((2, 8, 512, 64), True),
    ((1, 1, 1, 64), False)])
def test_bf16_stored_ds_is_chosen_by_the_budget(shape, stored):
    """A bf16 ds entry is 2 bytes, so the budget holds twice the f32
    batch; its rows are copied 16 bytes (8 values) at a time, so T must
    be a multiple of 8."""
    assert ca.flash_bwd_plan(*shape, True, BF16).stored_ds is stored


def test_bf16_ds_halves_the_buffer():
    """At the training shape the bf16 ds buffer takes 268 MB, the f32 one
    537 MB: the same ``[B * H, T, T]`` entries at 2 bytes."""
    B, H, T = 8, 4, 2048
    f32 = ca._DS_ITEM[torch.float32][0] * B * H * T * T
    bf16 = ca._DS_ITEM[BF16][0] * B * H * T * T
    assert (f32, bf16) == (536870912, 268435456)
