"""The block layouts of the FPS and ball-query kernels (csrc/fps.cu,
csrc/ballquery.cu), held on the CPU.

The kernels run only on the card; what they compute per block is fixed by
pure functions of the wrappers: ``ops.fps.block_layout`` (points a thread,
threads, shared-memory rest) and ``ops.ballquery.centers_per_block``, and
the ball query's schedule (tiles in index order, per-chunk hit counts, a
prefix over chunks, the block's exit once its centers are full) by
``ops.ballquery.tiled_emulation``. Indices and counts must be equal, exactly,
to the plain version and to the JAX package's reference.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvpnet_tpu.ops import reference as jref
from mvpnet_torch.ops import ballquery, fps, reference
from tests.test_torch_ops import H100_SHARED_BYTES

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
