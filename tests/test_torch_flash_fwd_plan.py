"""The flash-attention forward kernel's host side on the CPU: the launch
plan (``flash_fwd_plan``: shared memory, cover, determinism, a full wave
at the main paths' shapes, the longest query tiles first under causal
masking), the tile schedule the kernel walks under the plan's instances
(the causal bound, the segment-range skips, the part of each key tile a
warp's key split takes, the warps that skip a part and the parts formed
without masks, of ``csrc/flash_fwd.cu``, written out here in Python, as a
``hypothesis`` property against the visibility it must keep), and the
split-TF32 algebra of its products and online softmax (``rna_tf32``
hi/lo, ``lo.lo`` dropped, a fresh partial per 32 of D in the scores and
per key part in ``P . V``, P's k order permuted as the accumulator holds
it, the exponent in the log2 e form, the key splits' merge) against the
JAX ``_flash_forward`` in interpret mode. Tolerance of the algebra: atol
1e-5, the tolerance of the port's forward against JAX
(``test_torch_attention.py``): f32 throughout, sums in other orders. The
tensor cores' truncating adds and ``ex2.approx`` cannot be emulated here;
the card tests hold them. The bf16 instances (``flash_fwd_bf16``): their plan, and
their schedule by the same property, a warp taking each key tile in
steps of 32 keys (the key splits' parts, one warp walking them all);
the route a bf16 call takes by its operands' alignment (``wgmma`` fed by
TMA on 16-byte boundaries, else ``mma.sync``), and the ``wgmma``
instances' plan: shared memory, cover, warpgroups, the wave rule."""

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
LOG2E = np.float32(1.4426950408889634)

# (label, shape, causal) of the forward on the main paths: the training
# cell, the segments shape chip_smoke.py times, and the serving slice
MAIN = [("training", (8, 4, 2048, 128), True, 0),
        ("segments", (2, 8, 512, 128), False, 1),
        ("serving", (1, 8, 1024, 64), True, 1)]


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [64, 128])
def test_every_instance_fits_its_shared_memory(D):
    for t in ca._FWD_TILES[D]:
        smem = ca._fwd_smem(D, t)
        assert smem == 4 * (2 * t.rows * (D + 4) + t.stages * (
            2 * t.stream_rows * (D + 4) + t.stream_rows))
        assert smem <= MAX_SMEM
        assert t.blocks_per_sm * (smem + 1024) <= SM_SMEM
        assert t.rows % 16 == 0 and t.stages >= 2
        assert t.stream_rows % t.key_splits == 0
        assert t.stream_rows // t.key_splits in (16, 32)
        # the key splits' merge (a float4 a lane per 8 columns and one for
        # m and l, a warp of each split past the first) fits the ring
        merge = (t.key_splits - 1) * t.rows // 16 * 32 * 4 * (D // 8 + 1)
        assert merge <= t.stages * (2 * t.stream_rows * (D + 4)
                                    + t.stream_rows)


@pytest.mark.parametrize("B,H,T,D", [
    (1, 1, 1, 64), (1, 1, 15, 128), (2, 3, 33, 64), (8, 4, 2048, 128),
    (2, 8, 512, 128), (1, 8, 1024, 64), (3, 3, 1000, 128), (1, 2, 2047, 64),
    (7, 5, 4097, 128), (1, 8, 16, 64), (1, 8, 512, 64)])
def test_plan_covers_t_and_depends_on_the_shape_alone(B, H, T, D):
    plan = ca.flash_fwd_plan(B, H, T, D, True)
    assert plan.tiles * plan.rows >= T > (plan.tiles - 1) * plan.rows
    assert plan.grid == B * H * plan.tiles
    t = ca._FWD_TILES[D][plan.tile]
    assert plan.key_splits == t.key_splits
    assert plan.warps == plan.rows // 16 * plan.key_splits
    assert (plan.rows, plan.stream_rows, plan.stages, plan.blocks_per_sm,
            plan.key_splits) == tuple(t)
    assert plan.smem == ca._fwd_smem(D, t) <= MAX_SMEM
    assert ca.flash_fwd_plan(B, H, T, D, True) == plan
    assert ca.flash_fwd_plan(B, H, T, D, False) == plan
    large = ca._FWD_TILES[D][0]
    n_large = B * H * -(-T // large.rows)
    assert plan.tile == (0 if n_large >= ca._SMS * large.blocks_per_sm
                         else 1)


@pytest.mark.parametrize("label,shape,causal,tile", MAIN)
def test_main_path_shapes_fill_a_wave(label, shape, causal, tile):
    """The training shape takes the large instance (512 blocks of 128
    rows); the segments and serving shapes would give 64 large blocks, so
    they take the small one (256 blocks of 32 rows)."""
    plan = ca.flash_fwd_plan(*shape, causal)
    assert plan.tile == tile, label
    assert plan.grid >= ca._SMS


def _block_tiles(plan, BH, causal):
    """The query tile of each block in launch order: ``blockIdx.x % BH``
    is the head, ``blockIdx.x / BH`` the rank, and under causal masking
    rank 0 takes the last tile."""
    return [(plan.tiles - 1 - b // BH) if causal else b // BH
            for b in range(plan.grid)]


@pytest.mark.parametrize("B,H,T,D", [(8, 4, 2048, 128), (1, 8, 1024, 64),
                                     (2, 3, 1000, 128), (1, 1, 33, 64)])
def test_causal_order_takes_the_longest_tiles_first(B, H, T, D):
    """Under causal masking the key tiles a block walks never grow along
    the launch order, and every (head, query tile) is launched once."""
    plan = ca.flash_fwd_plan(B, H, T, D, True)
    tiles = _block_tiles(plan, B * H, True)
    n_st = -(-T // plan.stream_rows)
    walked = [min((q * plan.rows + plan.rows - 1) // plan.stream_rows + 1,
                  n_st) for q in tiles]
    assert walked == sorted(walked, reverse=True)
    assert walked[0] == n_st
    heads = [b % (B * H) for b in range(plan.grid)]
    assert Counter(zip(heads, tiles)) == Counter(
        {(h, q): 1 for h in range(B * H) for q in range(plan.tiles)})
    assert _block_tiles(plan, B * H, False) == sorted(tiles)


# ---------------------------------------------------------------------------
# the tile schedule of csrc/flash_fwd.cu
# ---------------------------------------------------------------------------

def _seg_range(seg, row0, n, T):
    """``seg_range``: (min, max) id over rows [row0, row0 + n) below T."""
    ids = seg[row0:min(row0 + n, T)]
    return (int(ids.min()), int(ids.max())) if len(ids) else (INT_MAX,
                                                              INT_MIN)


def _meet(a, b):
    """``seg_meet`` (``_seg_block_relevant``)."""
    return a[0] <= b[1] and a[1] >= b[0] and a[1] > 0 and b[1] > 0


def _visits(seg, T, causal, rows, bs, splits):
    """``{(query tile, key tile): visits}`` of the kernel; the (block, key
    tile, row group, split) whose products a warp skips; and those it
    forms with no mask (``inside``). The warp of split ``s`` takes rows
    ``[s * sub, (s + 1) * sub)`` of each key tile."""
    sub = bs // splits
    n_st = -(-T // bs)
    visits, skipped, inside = Counter(), set(), set()
    for blk in range(-(-T // rows)):
        q0 = blk * rows
        end = min((q0 + rows - 1) // bs + 1, n_st) if causal else n_st
        own = None if seg is None else _seg_range(seg, q0, rows, T)
        for t in range(end):                              # next_tile
            if seg is not None and not _meet(own, _seg_range(seg, t * bs,
                                                             bs, T)):
                continue
            visits[blk, t] += 1
            for w in range(rows // 16):
                for p in range(splits):
                    w0, k0 = q0 + 16 * w, t * bs + p * sub
                    if w0 >= T or k0 >= T or (causal and k0 > w0 + 15):
                        skipped.add((blk, t, w, p))
                    elif seg is None and k0 + sub <= T and (
                            not causal or k0 + sub - 1 <= w0):
                        inside.add((blk, t, w, p))
    return visits, skipped, inside


def _visible(seg, T, causal):
    """``[query, key]`` visibility the kernel must keep."""
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
def test_kernel_visits_every_visible_tile_pair_once(case, D):
    T, causal, seg = case
    vis = _visible(seg, T, causal)
    for t in ca._FWD_TILES[D]:
        visits, skipped, inside = _visits(seg, T, causal, t.rows,
                                          t.stream_rows, t.key_splits)
        sub = t.stream_rows // t.key_splits
        assert max(visits.values(), default=1) == 1
        for blk in range(-(-T // t.rows)):
            rows = slice(blk * t.rows, (blk + 1) * t.rows)
            for s in range(-(-T // t.stream_rows)):
                keys = slice(s * t.stream_rows, (s + 1) * t.stream_rows)
                # a pair with a visible pair once; a skipped one none
                assert visits[blk, s] == 1 if vis[rows, keys].any() \
                    else visits[blk, s] <= 1
        for blk, s, w, p in skipped:
            rows = slice(blk * t.rows + 16 * w, blk * t.rows + 16 * w + 16)
            k0 = s * t.stream_rows + p * sub
            assert not vis[rows, k0:k0 + sub].any()
        # a part formed with no mask: every key of it in T and visible to
        # every row of the warp below T
        for blk, s, w, p in inside:
            rows = slice(blk * t.rows + 16 * w,
                         min(blk * t.rows + 16 * w + 16, T))
            k0 = s * t.stream_rows + p * sub
            assert k0 + sub <= T
            assert vis[rows, k0:k0 + sub].all()
        # every visible pair is formed by its warp
        for q, k in zip(*np.nonzero(vis)):
            blk, s = q // t.rows, k // t.stream_rows
            assert visits[blk, s] == 1
            assert (blk, s, q % t.rows // 16,
                    k % t.stream_rows // sub) not in skipped


def test_schedule_skips_what_segments_and_the_cone_rule_out():
    """The property's counterpart: packed segments and the causal cone do
    cut tiles and warps, and interior tiles go without masks."""
    seg = np.array([1] * 40 + [2] * 40 + [3] * 40 + [0] * 8, np.int32)
    visits, _, _ = _visits(seg, 128, False, 32, 32, 2)
    assert len(visits) < 4 * 4
    # ids (1, 1) against (2, 3), both ways
    assert (0, 2) not in visits and (2, 0) not in visits
    visits, skipped, inside = _visits(None, 256, True, 128, 32, 1)
    assert len(visits) == 4 + 8
    assert (0, 0, 7, 0) in inside and (0, 1, 0, 0) in skipped
    assert (1, 7, 7, 0) not in inside and (1, 7, 7, 0) not in skipped
    # the small instance at T = 20: split 1 (keys 16..31) lies past the
    # cone of rows 0..15 and is masked for rows 16..19 (keys 16..19 below
    # T); split 0 (keys 0..15) is masked for rows 0..15, whole for 16..19
    _, skipped, inside = _visits(None, 20, True, 32, 32, 2)
    assert (0, 0, 0, 1) in skipped
    assert (0, 0, 1, 1) not in skipped and (0, 0, 1, 1) not in inside
    assert (0, 0, 0, 0) not in inside and (0, 0, 1, 0) in inside


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
    """``a @ b`` as the kernel's products take it: each operand split
    into hi and lo, three products (``lo.hi + hi.lo + hi.hi``, ``lo.lo``
    dropped) summed exactly over each chunk of the contraction, each
    chunk's partial rounded to f32 and added to an f32 accumulator in
    order."""
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


def _fma(a, b, c):
    """f32 ``fmaf``: ``a * b + c`` rounded once."""
    f8 = np.float64
    return (np.asarray(a, f8) * np.asarray(b, f8)
            + np.asarray(c, f8)).astype(np.float32)


def _kernel_forward(q, k, v, seg, causal, scale, sub, splits):
    """(O, LSE) as the kernel forms them: scores over D in partials of 32;
    key parts of ``sub`` rows (K and V past T as zeros, masked), part i
    taken by split ``i % splits``; each split, per part, forms the scaled
    scores with masked pairs at -inf, the part's max, ``corr = 2^((m -
    m_new) log2 e)``, ``p = 2^(fma(x, log2 e, -m_new log2 e))``, ``l = l *
    corr + sum p``, and ``P . V`` with P and V's rows in the accumulator's
    k order (k = t is column 2t, k = t + 4 is 2t + 1) as one fresh partial
    folded in by ``fma(acc, corr, partial)``; m starts at -1e30. Split 0
    then takes the others' states in split order, ``m = max``, each side
    scaled by ``2^((m_side - m) log2 e)``; l is clamped at 1e-30."""
    B, H, T, D = q.shape
    f4 = np.float32
    s = _mm3(q, np.swapaxes(k, -1, -2), 32)
    vis = np.broadcast_to(np.tril(np.ones((T, T), bool)) if causal
                          else np.ones((T, T), bool), s.shape)
    if seg is not None:
        vis = vis & ((seg[:, :, None] == seg[:, None, :])
                     & (seg[:, :, None] > 0))[:, None]
    x = np.where(vis, (s * f4(scale)).astype(f4), f4(-np.inf))
    n_parts = -(-T // (sub * splits)) * splits
    pad = n_parts * sub - T
    x = np.concatenate([x, np.full((B, H, T, pad), -np.inf, f4)], -1)
    vp = np.concatenate([v, np.zeros((B, H, pad, D), f4)], 2)
    perm = np.array([0, 2, 4, 6, 1, 3, 5, 7])
    states = []
    for split in range(splits):
        m = np.full((B, H, T), -1e30, f4)
        l = np.zeros((B, H, T), f4)
        acc = np.zeros((B, H, T, D), f4)
        for i in range(split, n_parts, splits):
            keys = i * sub + np.concatenate([8 * j + perm
                                             for j in range(sub // 8)])
            xt = x[..., keys]
            m_new = np.maximum(m, xt.max(-1))
            corr = np.exp2(((m - m_new) * LOG2E).astype(f4)).astype(f4)
            p = np.exp2(_fma(xt, LOG2E, (-m_new * LOG2E)[..., None])
                        ).astype(f4)
            l = (l * corr + p.sum(-1, dtype=f4)).astype(f4)
            part = _mm3(p, vp[:, :, keys], sub)
            acc = _fma(acc, corr[..., None], part)
            m = m_new
        states.append((m, l, acc))
    m, l, acc = states[0]
    for mo, lo, acco in states[1:]:
        m_new = np.maximum(m, mo)
        cs = np.exp2(((m - m_new) * LOG2E).astype(f4)).astype(f4)
        co = np.exp2(((mo - m_new) * LOG2E).astype(f4)).astype(f4)
        l = _fma(lo, co, (l * cs).astype(f4))
        acc = _fma(acco, co[..., None], (acc * cs[..., None]).astype(f4))
        m = m_new
    lf = np.maximum(l, f4(1e-30))
    out = (acc * (f4(1) / lf)[..., None]).astype(f4)
    return out, (m + np.log(lf)).astype(f4)


def _packed(B, T):
    """Two packed sequences a row and a padding tail."""
    seg = np.zeros((B, T), np.int32)
    for b in range(B):
        a, c = T // 2 - 8 * b, T - 8 - 4 * b
        seg[b, :a], seg[b, a:c] = 1, 2
    return seg


@pytest.mark.parametrize("shape", [(2, 2, 64, 16), (1, 2, 80, 64)])
@pytest.mark.parametrize("causal,with_segments", [(True, False),
                                                  (False, True),
                                                  (True, True)])
@pytest.mark.parametrize("tile", [0, 1])
def test_split_tf32_forward_matches_jax(shape, causal, with_segments, tile):
    """Each instance's algebra: the large one's one warp a row group over
    key tiles of 32, the small one's two key splits of 16 and their
    merge."""
    B, H, T, D = shape
    rng = np.random.RandomState(11)
    q, k, v = (rng.randn(*shape).astype(np.float32) for _ in range(3))
    seg = _packed(B, T) if with_segments else None
    scale = D ** -0.5
    jseg = None if seg is None else jnp.asarray(seg)
    out_j, lse_j = jpa._flash_forward(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jseg, causal, scale,
                                      16, 16, True)
    t = ca._FWD_TILES[64][tile]
    out, lse = _kernel_forward(q, k, v, seg, causal, scale,
                               t.stream_rows // t.key_splits, t.key_splits)
    live = np.ones((B, T), bool) if seg is None else seg > 0
    # padding rows are unspecified in the JAX kernel; the port writes 0s
    # and an LSE of -1e30, as flash_attention_plain defines them
    ot, oj = out.transpose(0, 2, 1, 3), np.asarray(out_j).transpose(
        0, 2, 1, 3)
    np.testing.assert_allclose(ot[live], oj[live], atol=ATOL, rtol=0)
    lt, lj = lse.transpose(0, 2, 1), np.asarray(lse_j).transpose(0, 2, 1)
    np.testing.assert_allclose(lt[live], lj[live], atol=ATOL, rtol=0)
    assert not ot[~live].any()
    assert (lt[~live] == np.float32(-1e30)).all()


# ---------------------------------------------------------------------------
# the bf16 instances (flash_fwd_bf16)
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16
STEP = 32                  # keys a warp takes at a time (CfgB::SUB)


@pytest.mark.parametrize("D", [64, 128])
def test_bf16_instances_fit_their_shared_memory(D):
    """No Q planes (each warp's Q fragments live in registers): a stage
    holds K and V as bf16 rows of pitch D + 8 (16-byte rows, ldmatrix free
    of bank conflicts: D / 2 + 4 words, 4 mod 32) and the segment ids."""
    for t in ca._FWD_TILES_BF16[D]:
        smem = ca._fwd_smem(D, t, BF16)
        assert smem == 4 * t.stages * (t.stream_rows * (D + 8)
                                       + t.stream_rows)
        assert smem <= MAX_SMEM
        assert t.blocks_per_sm * (smem + 1024) <= SM_SMEM
        assert t.key_splits == 1 and t.stages >= 2 and t.rows % 16 == 0
        assert t.stream_rows % STEP == 0
        assert 2 * (D + 8) % 16 == 0 and (D // 2 + 4) % 32 == 4
    assert ca._fwd_tiles(BF16) is ca._FWD_TILES_BF16
    assert ca._fwd_tiles(torch.float32) is ca._FWD_TILES


@pytest.mark.parametrize("B,H,T,D", [
    (1, 1, 1, 64), (1, 1, 15, 128), (2, 3, 33, 64), (8, 4, 2048, 128),
    (2, 8, 512, 128), (1, 8, 1024, 64), (3, 3, 1000, 128), (1, 2, 2047, 64),
    (7, 5, 4097, 128), (17, 4, 2048, 128)])
def test_bf16_plan_covers_t_and_depends_on_the_shape_alone(B, H, T, D):
    """The mma.sync route (views 4 bytes off 16: copy width 2)."""
    plan = ca.flash_fwd_plan(B, H, T, D, True, BF16, 2)
    assert plan.route == "mma_sync"
    assert plan.tiles * plan.rows >= T > (plan.tiles - 1) * plan.rows
    assert plan.grid == B * H * plan.tiles
    t = ca._FWD_TILES_BF16[D][plan.tile]
    assert plan.warps == plan.rows // 16 and plan.key_splits == 1
    assert (plan.rows, plan.stream_rows, plan.stages, plan.blocks_per_sm,
            plan.key_splits) == tuple(t)
    assert plan.smem == ca._fwd_smem(D, t, BF16) <= MAX_SMEM
    assert ca.flash_fwd_plan(B, H, T, D, False, BF16, 2) == plan
    large = ca._FWD_TILES_BF16[D][0]
    n_large = B * H * -(-T // large.rows)
    assert plan.tile == (0 if n_large >= ca._SMS * large.blocks_per_sm
                         else 1)


@pytest.mark.parametrize("label,shape,causal,tile", [
    ("training", (8, 4, 2048, 128), True, 0),
    ("segments", (2, 8, 512, 128), False, 1),
    ("serving", (1, 8, 1024, 64), True, 1)])
def test_bf16_main_path_shapes(label, shape, causal, tile):
    """The training shape takes the large instance (512 blocks of 128
    rows); the other two would give 64 large blocks and take the small
    one (128 blocks of 64 rows: a warp each 16 on mma.sync, one consumer
    warpgroup on wgmma). Both routes pick alike."""
    for width, route in ((None, "wgmma"), (8, "wgmma"), (2, "mma_sync")):
        plan = ca.flash_fwd_plan(*shape, causal, BF16, width)
        assert plan.tile == tile and plan.route == route, label
        assert plan.grid == {0: 512, 1: 128}[tile]


@settings(max_examples=40, deadline=None)
@given(_cases(), st.sampled_from([64, 128]))
def test_bf16_kernel_visits_every_visible_tile_pair_once(case, D):
    """The bf16 kernel walks the same tiles in both of its passes (the max
    pass and the main one); a warp takes each tile in steps of 32 keys
    with the f32 kernel's skip and no-mask rules per step, which is
    ``_visits`` with the steps as its parts."""
    T, causal, seg = case
    vis = _visible(seg, T, causal)
    for t in ca._FWD_TILES_BF16[D]:
        steps = t.stream_rows // STEP
        visits, skipped, inside = _visits(seg, T, causal, t.rows,
                                          t.stream_rows, steps)
        assert max(visits.values(), default=1) == 1
        for blk, s, w, p in skipped:
            rows = slice(blk * t.rows + 16 * w, blk * t.rows + 16 * w + 16)
            k0 = s * t.stream_rows + p * STEP
            assert not vis[rows, k0:k0 + STEP].any()
        for blk, s, w, p in inside:
            rows = slice(blk * t.rows + 16 * w,
                         min(blk * t.rows + 16 * w + 16, T))
            k0 = s * t.stream_rows + p * STEP
            assert k0 + STEP <= T and vis[rows, k0:k0 + STEP].all()
        for q, k in zip(*np.nonzero(vis)):
            blk, s = q // t.rows, k // t.stream_rows
            assert visits[blk, s] == 1
            assert (blk, s, q % t.rows // 16,
                    k % t.stream_rows // STEP) not in skipped


def test_bf16_kernel_names_and_entry_types():
    """bf16 operands launch the ``_bf16`` entries of the same sources,
    with the f32 entries' C signatures (pointers, then B H T D, scale,
    causal, tile, copy width, stream)."""
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert ca._kernel_name(name, BF16) == name + "_bf16"
        assert ca._kernel_name(name, torch.float32) == name
        assert ca.KERNELS[name + "_bf16"] == ca.KERNELS[name]
        assert ca._ARGTYPES[name + "_bf16"] == ca._ARGTYPES[name]


# ---------------------------------------------------------------------------
# the bf16 wgmma instances (flash_fwd_bf16 on 16-byte aligned operands)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [64, 128])
def test_wgmma_instances_fit_their_shared_memory(D):
    """``CfgW``: 1024 bytes to reach the swizzle's 1024-byte period, Q as
    ``rows x D`` bf16 values (a 128-byte slab row per 64 of D), per stage
    K and V as ``stream_rows x D`` each, and ``2 stages + 1`` mbarriers;
    every slab a whole number of 1024-byte periods, one block an SM, a
    consumer warpgroup per 64 rows."""
    for t in ca._FWD_TILES_WGMMA[D]:
        smem = ca._fwd_smem(D, t, BF16, "wgmma")
        assert smem == (1024 + 2 * t.rows * D + t.stages * 4 * t.stream_rows
                        * D + 8 * (2 * t.stages + 1))
        assert smem <= MAX_SMEM and t.blocks_per_sm == 1
        assert t.rows % 64 == 0 and t.stream_rows == 64
        assert t.key_splits == 1 and t.stages >= 2
        assert t.rows * 128 % 1024 == 0 and t.stream_rows * 128 % 1024 == 0
    assert ca._fwd_tiles(BF16, "wgmma") is ca._FWD_TILES_WGMMA
    assert ca._fwd_tiles(BF16) is ca._FWD_TILES_BF16


@pytest.mark.parametrize("B,H,T,D", [
    (1, 1, 1, 64), (1, 1, 15, 128), (2, 3, 33, 64), (8, 4, 2048, 128),
    (2, 8, 512, 128), (1, 8, 1024, 64), (3, 3, 1000, 128), (1, 2, 2047, 64),
    (7, 5, 4097, 128), (17, 4, 2048, 128), (4, 20, 300, 128)])
def test_wgmma_plan_covers_t_and_depends_on_the_shape_alone(B, H, T, D):
    """16-byte copies (width 8, the default) take the wgmma route: its
    instance by the same wave rule, rows / 64 consumer warpgroups and a
    producer warpgroup, the grid covering T; a function of the shapes,
    dtype and width alone, causal or not."""
    plan = ca.flash_fwd_plan(B, H, T, D, True, BF16)
    assert plan == ca.flash_fwd_plan(B, H, T, D, True, BF16, 8)
    assert plan == ca.flash_fwd_plan(B, H, T, D, False, BF16, 8)
    assert plan.route == "wgmma"
    t = ca._FWD_TILES_WGMMA[D][plan.tile]
    assert (plan.rows, plan.stream_rows, plan.stages, plan.blocks_per_sm,
            plan.key_splits) == tuple(t)
    assert plan.warps == 4 * (plan.rows // 64 + 1)
    assert plan.tiles * plan.rows >= T > (plan.tiles - 1) * plan.rows
    assert plan.grid == B * H * plan.tiles
    assert plan.smem == ca._fwd_smem(D, t, BF16, "wgmma") <= MAX_SMEM
    large = ca._FWD_TILES_WGMMA[D][0]
    n_large = B * H * -(-T // large.rows)
    assert plan.tile == (0 if n_large >= ca._SMS * large.blocks_per_sm
                         else 1)
    # f32 operands have one route, whatever the width
    assert ca.flash_fwd_plan(B, H, T, D, True).route == "mma_sync"


def _bf16_at(offset):
    return torch.zeros(64 + offset, dtype=BF16)[offset:]


@pytest.mark.parametrize("offsets,width,route", [
    ((0, 0, 0, 0), 8, "wgmma"), ((2, 0, 0, 0), 2, "mma_sync"),
    ((0, 2, 0, 0), 2, "mma_sync"), ((0, 0, 6, 0), 2, "mma_sync"),
    ((0, 0, 0, 4), 2, "mma_sync"), ((8, 8, 8, 8), 8, "wgmma"),
    ((1, 0, 0, 0), 0, None)])
def test_bf16_route_follows_the_operands_alignment(offsets, width, route):
    """q, k, v and O all on 16-byte boundaries take wgmma (TMA loads only
    from them); any one of them 4 bytes off (a view) takes mma.sync on
    4-byte copies; 2 bytes off 4 no kernel takes."""
    ts = [_bf16_at(o) for o in offsets]
    assert ca.flash_copy_width(*ts) == width
    if route is not None:
        assert ca.flash_fwd_plan(2, 2, 64, 64, True, BF16,
                                 width).route == route


def test_route_counts_start_at_zero_and_reset():
    FWD = "flash_fwd_bf16"
    ca.reset_launch_counts()
    assert ca.route_counts(FWD) == {"wgmma": 0, "mma_sync": 0}
    ca._routes[FWD]["wgmma"] += 2
    assert ca.route_counts(FWD)["wgmma"] == 2
    ca.reset_launch_counts()
    assert ca.route_counts(FWD) == {"wgmma": 0, "mma_sync": 0}
