"""The block layouts of the FPS, ball-query and three-NN kernels
(csrc/fps.cu, csrc/ballquery.cu, csrc/knn.cu), held on the CPU.

The kernels run only on the card; what they compute per block is fixed by
pure functions of the wrappers: ``ops.fps.block_layout`` (points a thread,
threads, shared-memory rest), ``ops.ballquery.centers_per_block`` and
``ops.knn.layout`` (lanes a query, queries a thread, refs a tile); the ball
query's schedule (tiles in index order, per-chunk hit counts, a prefix over
chunks, the block's exit once its centers are full) by
``ops.ballquery.tiled_emulation``; and the three-NN's (lanes scanning
strided quads of each tile with strict '<' insertion, then the shuffle
merge in (distance, index) order) by ``ops.knn.split_emulation``; and
the gated fusion kNN's (rows 6 and 7: lanes a query row, the block's and
the warp's gates, the merge in (distance, visit position) order) by
``ops.knn_gated.split_emulation``, with its rule ``ops.knn_gated.layout``
(lanes a query row, rows a block). Indices
and counts must be equal, exactly, to the plain version and to the JAX
package's reference; distances equal bit for bit to the plain version and
within 1e-5 of the JAX package's (its reference expands |a|^2 - 2ab + |b|^2).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mvpnet_tpu.ops import reference as jref
from mvpnet_tpu.ops.pallas import knn as pknn
from mvpnet_tpu.ops.pallas import knn_bucketed as pgated
from mvpnet_torch.ops import KERNELS, ballquery, fps, knn_gated, knn_resident, morton, reference
from tests.test_torch_ops import GATED_ATOL, H100_SHARED_BYTES, _variant_case, small_gated_tiles  # noqa: F401

knn = KERNELS["knn"]  # the brute three-NN wrapper module (ops.knn is the dispatched function)

H100_SMS = 132


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# Ball query: the kernel's tiled schedule
# ---------------------------------------------------------------------------


def _bq_case(rng, case):
    """(centers, points, valid_mask, radius) on 2 rows of 300 points (not a
    multiple of the 64-point test tile)."""
    pts = rng.uniform(-1, 1, size=(2, 300, 3)).astype(np.float32)
    centers = pts[:, :40].copy()
    mask = None
    radius = 0.4
    if case == "duplicates":  # every point twice: ties in index order
        pts[:, 150:] = pts[:, :150]
    elif case == "empty_balls":
        centers[:, ::3] += 50.0  # nearest-point fallback, lower index on ties
    elif case == "masked":
        mask = rng.uniform(size=(2, 300)) > 0.4
        mask[:, :5] = False
    elif case == "full_beside_empty":
        # in each block, balls full in the first tile next to balls that
        # stay empty and walk every tile
        radius = 5.0
        centers[:, 1::2] += 50.0
    return centers, pts, mask, radius


@pytest.mark.parametrize("case", ["plain", "duplicates", "empty_balls", "masked", "full_beside_empty"])
@pytest.mark.parametrize("k", [1, 32, 64])
@pytest.mark.parametrize("per_block", [1, 3, 32])
def test_ball_query_tiled_emulation_matches_plain_and_jax(rng, case, k, per_block):
    centers, pts, mask, radius = _bq_case(rng, case)
    vm = None if mask is None else _t(mask)
    got_idx, got_cnt, tiles = ballquery.tiled_emulation(_t(centers), _t(pts), radius, k, vm, per_block=per_block, tile=64)
    want_idx, want_cnt = reference.ball_query(_t(centers), _t(pts), radius, k, vm)
    assert torch.equal(got_idx, want_idx) and torch.equal(got_cnt, want_cnt)
    jm = None if mask is None else jnp.asarray(mask)
    j_idx, j_cnt = jref.ball_query(jnp.asarray(centers), jnp.asarray(pts), radius, k, valid_mask=jm)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(j_cnt))
    blocks = 2 * -(-40 // per_block)
    assert blocks <= tiles <= blocks * -(-300 // 64)
    if case == "full_beside_empty":
        # the far centers keep every block walking all 5 tiles; alone, the
        # full ones stop after the first
        assert tiles == blocks * 5 or per_block == 1
        near = _t(centers[:, ::2].copy())
        _, cnt, near_tiles = ballquery.tiled_emulation(near, _t(pts), radius, k, per_block=per_block, tile=64)
        assert (cnt == k).all() and near_tiles == 2 * -(-near.shape[1] // per_block)


# chunk request SA1-SA4 (B=1), train step SA1 (B=8), scene SA1-SA4 (B=4)
@pytest.mark.parametrize(
    "b,m", [(1, 1024), (1, 256), (1, 64), (1, 16), (8, 1024), (8, 256), (4, 8192), (4, 2048), (4, 512), (4, 128)]
)
@pytest.mark.parametrize("sms", [H100_SMS, 8])
def test_ball_query_centers_per_block(b, m, sms):
    """The grid keeps about two blocks an SM: at least 2 x SMs blocks, or
    one center a block; and as many centers a block as allow it, up to
    MAX_CENTERS."""
    c = ballquery.centers_per_block(b, m, sms)
    assert 1 <= c <= ballquery.MAX_CENTERS
    blocks = b * -(-m // c)
    assert blocks >= 2 * sms or c == 1
    assert c == ballquery.MAX_CENTERS or b * m < 2 * sms * (c + 1)
    if (b, m, sms) == (1, 1024, H100_SMS):  # the chunk request's SA1: 342 blocks
        assert c == 3
    if (b, m, sms) == (4, 8192, H100_SMS):  # the scene's SA1: 1024 blocks of 32
        assert c == ballquery.MAX_CENTERS


# ---------------------------------------------------------------------------
# FPS: the block kernel's register layout
# ---------------------------------------------------------------------------


# rows of every length class: one warp, a power of two of points a thread,
# the SA levels of the three paths, and the longest row ``route`` sends to
# the block kernel on an H100 (14,432 points)
@pytest.mark.parametrize(
    "n",
    [1, 2, 31, 32, 33, 63, 64, 65, 100, 255, 256, 257, 511, 512, 513, 1000, 1023, 1024, 1025, 2047, 2048, 2049,
     4096, 8191, 8192, 8193, 14431, 14432],
)
def test_fps_block_layout(n):
    """Whole warps: a point a thread up to SHORT_ROW_THREADS, and
    BLOCK_THREADS for rows those cannot hold; a power of two of points a
    thread, up to BLOCK_POINTS (a template instance of the kernel), the
    fewest that hold the row; what the registers cannot hold goes to shared
    memory."""
    p, t, shared = fps.block_layout(n)
    assert p & (p - 1) == 0 and 1 <= p <= fps.BLOCK_POINTS
    assert t % 32 == 0 and 32 <= t <= fps.BLOCK_THREADS
    if n <= fps.SHORT_ROW_THREADS * fps.BLOCK_POINTS:
        assert t == min(fps.SHORT_ROW_THREADS, 32 * -(-n // 32))
    else:
        assert t == fps.BLOCK_THREADS
    assert shared == max(0, n - p * t)
    if shared:
        assert p == fps.BLOCK_POINTS
    else:
        assert p * t >= n and (p == 1 or (p // 2) * t < n)
    if n == 8192:  # SA1 rows of the chunk and train paths: all in registers
        assert (p, t, shared) == (fps.BLOCK_POINTS, fps.BLOCK_THREADS, 0)
    if n == 1024:  # SA2 rows of the chunk and train paths
        assert (p, t, shared) == (4, fps.SHORT_ROW_THREADS, 0)


def test_fps_block_layout_longest_row():
    """The longest row the block kernel takes on an H100 keeps 8192 points
    in registers and the rest in shared memory; one more point takes the
    cluster kernel."""
    longest = H100_SHARED_BYTES // fps.ROW_BYTES
    assert fps.route(longest, H100_SHARED_BYTES) == "fps"
    assert fps.route(longest + 1, H100_SHARED_BYTES) == "fps_perrow"
    assert fps.block_layout(longest) == (fps.BLOCK_POINTS, fps.BLOCK_THREADS, longest - 8192)


# ---------------------------------------------------------------------------
# Three-NN: the kernel's split schedule and its layout rule
# ---------------------------------------------------------------------------


def _knn_case(rng, case, n):
    """(queries (2, 37, 3), refs (2, n, 3)): 37 queries end inside a block's
    lane groups, and n = 301 inside a quad, a tile of 64 and a lane group."""
    q = rng.uniform(-2, 2, size=(2, 37, 3)).astype(np.float32)
    r = rng.uniform(-2, 2, size=(2, n, 3)).astype(np.float32)
    if case == "duplicates":  # every ref twice, queries on refs: exact ties
        r[:, n // 2 : 2 * (n // 2)] = r[:, : n // 2]
        q[:, :5] = r[:, :5]
    elif case == "sentinels":  # masked refs at the 1e9 sentinel
        r[:, ::7] = reference.MASK_COORD
    return q, r


@pytest.mark.parametrize("case", ["plain", "duplicates", "sentinels"])
@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("lanes", [1, 2, 8, 32])
def test_knn_split_emulation_matches_plain_and_jax(rng, case, k, lanes):
    """301 refs in tiles of 64 (tails of tiles, quads and lane groups), and 9
    refs at one tile (fewer than lanes x k for every lanes > 1)."""
    for n, tile in ((301, 64), (9, 12)):
        q, r = _knn_case(rng, case, n)
        got_d, got_i = knn.split_emulation(_t(q), _t(r), k, lanes, tile)
        want_d, want_i = reference.knn(_t(q), _t(r), k)
        assert torch.equal(got_d, want_d) and torch.equal(got_i, want_i), (n, tile)
        if case == "sentinels" and n == 9:
            continue  # fewer than k real refs: the JAX reference gives masked refs +inf, the port 1e9
        j_d, j_i = jref.knn(jnp.asarray(q), jnp.asarray(r), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(j_i))
        np.testing.assert_allclose(got_d.numpy(), np.asarray(j_d), atol=1e-5)


@pytest.mark.parametrize("case", ["plain", "duplicates", "sentinels"])
@pytest.mark.parametrize("lanes", [1, 8])
def test_knn_split_emulation_matches_jax_kernel(rng, monkeypatch, case, lanes):
    """Against the Pallas kernel itself in interpret mode, on tiles of 16
    queries and 128 refs, so its grid walks several of each."""
    monkeypatch.setattr(pknn, "_TILE_M", 16)
    monkeypatch.setattr(pknn, "_TILE_N", 128)
    q, r = _knn_case(rng, case, 301)
    with pltpu.force_tpu_interpret_mode():
        want_d, want_i = pknn.knn_pallas(jnp.asarray(q), jnp.asarray(r), 3)
    got_d, got_i = knn.split_emulation(_t(q), _t(r), 3, lanes, 64)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=1e-5)


# FP1-FP4 of the chunk request (B=1), the train step (B=8) and the scene at
# the high-resolution config (B=4): (batch, queries, refs)
FP_SHAPES = [
    (1, 8192, 1024), (1, 1024, 256), (1, 256, 64), (1, 64, 16),
    (8, 8192, 1024), (8, 1024, 256), (8, 256, 64), (8, 64, 16),
    (4, 102400, 8192), (4, 8192, 2048), (4, 2048, 512), (4, 512, 128),
]


@pytest.mark.parametrize("b,m,n", FP_SHAPES)
@pytest.mark.parametrize("sms", [H100_SMS, 8])
def test_knn_layout(b, m, n, sms):
    """A layout the kernel takes: lanes a power of two up to MAX_LANES, each
    with two quads of a tile (one on rows of a single quad); queries a thread
    one of QUERIES_PER_THREAD; a tile of whole quads that holds the row up to
    MAX_TILE. More lanes only while the card is short of threads, more
    queries a thread only while it is not; and work on every SM at the
    chunk's FP1 and FP2."""
    lanes, per_thread, tile = knn.layout(b, m, n, sms)
    assert lanes & (lanes - 1) == 0 and 1 <= lanes <= knn.MAX_LANES
    assert per_thread in knn.QUERIES_PER_THREAD
    assert tile % knn.QUAD == 0 and tile == min(knn.MAX_TILE, knn.QUAD * -(-n // knn.QUAD))
    assert lanes == 1 or 2 * lanes * knn.QUAD <= tile
    threads = b * m * lanes // per_thread
    fill = sms * knn.FILL_WARPS * 32
    assert lanes == 1 or per_thread == 1
    if lanes > 1:  # the lanes before the last did not fill the card
        assert threads // 2 < fill
    blocks = b * -(-m // (knn.THREADS // lanes * per_thread))
    if b == 1 and m in (8192, 1024) and sms == H100_SMS:
        assert blocks >= sms
    if (b, m, n) == (4, 102400, 8192) and sms == H100_SMS:  # the scene's FP1: several queries a thread
        assert per_thread > 1 and lanes == 1


# ---------------------------------------------------------------------------
# Rows 6 and 7: the gated search's schedule and its layout rule
# ---------------------------------------------------------------------------

# (lanes, rows a block) on the test's 32-row query tiles: one row a warp
# lane-split 32 ways, the rule's range, and blocks that cut a tile in parts
GATED_LAYOUTS = [(1, 32), (4, 8), (8, 16), (32, 8)]


@pytest.mark.parametrize("case", ["plain", "sentinel", "masked", "duplicates"])
@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("variant", ["gated", "resident"])
def test_gated_split_emulation_matches_plain_and_jax(rng, small_gated_tiles, case, k, variant):
    """The gated kernels' schedule (lanes, block and warp gates, the row's
    insertion threshold, the merge by visit position) equals their plain
    version bit for bit at every layout, visit-order ties included, and JAX's
    _knn_forward (row 6) or _knn_forward_demand(use_vmem=True) (row 7) in
    interpret mode index for index, on tiles of 32 rows and 64 refs; and the
    warp gate skips pairs the tile gate lets through."""
    q, r = _variant_case(rng, case)
    with pltpu.force_tpu_interpret_mode():
        if variant == "gated":
            want_d, want_i = pgated._knn_forward(jnp.asarray(q), jnp.asarray(r), k)
        else:
            want_d, want_i = pgated._knn_forward_demand(jnp.asarray(q), jnp.asarray(r), k, use_vmem=True)
    plain_d, plain_i = morton.gated_plain(_t(q), _t(r), k, 32, 64)
    np.testing.assert_array_equal(plain_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(plain_d.numpy(), np.asarray(want_d), atol=GATED_ATOL, rtol=1e-6)
    scanned = {}
    for lanes, rows in GATED_LAYOUTS:
        d, i, scanned[lanes] = knn_gated.split_emulation(_t(q), _t(r), k, 32, 64, lanes, rows,
                                                         first_always=variant == "gated")
        assert torch.equal(i, plain_i) and torch.equal(d, plain_d), (lanes, rows)
    assert scanned[32] <= scanned[1] <= 2 * 100 * 1024
    if case == "plain":
        assert scanned[32] < scanned[1]


@pytest.mark.parametrize(
    "b,m,tile_m,tile_n",
    [(8, 8192, 256, 2048), (8, 8192, 64, 1024), (4, 102400, 256, 8192), (1, 8192, 256, 2048), (2, 300, 64, 2048),
     (1, 100, 100, 8192)],
    ids=["train_row6", "train_row7", "scene_row6", "chunk", "small", "short_tile"],
)
@pytest.mark.parametrize("sms", [H100_SMS, 8])
def test_gated_layout(b, m, tile_m, tile_n, sms):
    """A layout the kernels take: lanes a power of two from LANES
    (BIG_TILE_LANES on the 8192-ref tiles) up to MAX_LANES, doubled only
    while the grid's threads do not fill the card; rows a block the tile's or
    as many as MAX_THREADS hold."""
    lanes, rows = knn_gated.layout(b, m, tile_m, tile_n, sms)
    first = knn_gated.BIG_TILE_LANES if tile_n > morton.TILE_N else knn_gated.LANES
    assert lanes & (lanes - 1) == 0 and first <= lanes <= knn_gated.MAX_LANES
    assert rows == min(tile_m, knn_gated.MAX_THREADS // lanes) and rows * lanes <= knn_gated.MAX_THREADS
    fill = knn_gated.SM_THREADS * sms
    if lanes > first:  # doubled: the card was short of threads
        assert b * m * lanes // 2 < fill
    if lanes < knn_gated.MAX_LANES:
        assert b * m * lanes >= fill
    if sms == H100_SMS and (b, m) == (8, 8192):  # the train shape
        assert (lanes, rows) == (8, 64)
    if sms == H100_SMS and (b, m) == (4, 102400):  # the scene's tiles of 8192 refs
        assert (lanes, rows) == (16, 32)


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("case", ["plain", "sentinel", "masked"])
def test_need_pairs_matches_a_brute_count(rng, case):
    """chip_smoke.need_pairs (the gated searches' bound) against a count
    over every (row, tile) in numpy: the tiles whose box lies nearer to the
    row's point than its k-th distance, at least one a row; and every tile
    holding one of the row's k nearest refs is among them."""
    q, r = _variant_case(rng, case)
    tile_n, k = 64, 3
    p = morton.prepare(_t(q), _t(r), 32, tile_n)
    lo, hi = morton.tile_bounds(p.r_sorted, tile_n)
    d, i = morton.gated_plain(_t(q), _t(r), k, 32, tile_n)
    kth = d[..., k - 1]
    pairs, per_row = _chip_smoke().need_pairs(torch, _t(q), kth, [(lo, hi)], tile_n, rows_a_step=7)
    want = 0
    lo_n, hi_n, kth_n = lo.numpy(), hi.numpy(), kth.numpy()
    tile_of = torch.empty_like(p.r_order)
    tile_of.scatter_(1, p.r_order, torch.arange(p.r_order.shape[1]).expand_as(p.r_order) // tile_n)
    for b in range(q.shape[0]):
        for m in range(q.shape[1]):
            n = 0
            for t in range(lo_n.shape[1]):
                gap = np.maximum(np.maximum(lo_n[b, t] - q[b, m], q[b, m] - hi_n[b, t]), 0.0)
                n += float((gap * gap).sum()) < kth_n[b, m]
            want += max(n, 1)
            near = set(tile_of[b, i[b, m].long()].tolist())
            if case == "plain":  # no sentinel among the neighbors: their tiles bound them
                assert n >= len(near)
    assert pairs == want * tile_n and per_row == pytest.approx(want / (q.shape[0] * q.shape[1]))
