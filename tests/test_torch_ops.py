"""The port's point ops (mvpnet_torch.ops, plain versions on the CPU) against
the JAX package's: the jnp reference, and the gated Pallas kNN in TPU
interpret mode.

Inputs are made from a numpy seed and fed to both packages. Indices must be
equal on continuous random geometry (ties are measure-zero there, apart from
the deliberate duplicate-point case, where both break them to the lower
index). Distances agree within 1e-5 absolute: the JAX reference expands
|a|^2 - 2ab + |b|^2 while the port (and the kernels) compute (a - b)^2.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mvpnet_tpu.config import Config as JaxConfig
from mvpnet_tpu.core.camera import unproject_views as jax_unproject_views
from mvpnet_tpu.ops import reference as jref
from mvpnet_tpu.ops.pallas import knn_bucketed as pgated
from mvpnet_tpu.train.step import prepare_batch as jax_prepare_batch
from mvpnet_torch import ops
from mvpnet_torch.config import Config
from mvpnet_torch.core.camera import unproject_views
from mvpnet_torch.ops import ballquery, fps, knn_bucketed, reference
from mvpnet_torch.train.step import prepare_batch


knn_brute = ops.KERNELS["knn"]


def _pts(rng, b, n, scale=2.0):
    return rng.uniform(-scale, scale, size=(b, n, 3)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(autouse=True)
def _auto_impl():
    ops.set_impl("auto")
    ops.reset_launch_counts()
    yield
    ops.set_impl("auto")


# ---------------------------------------------------------------------------
# FPS
# ---------------------------------------------------------------------------


def _fps_mask(case, b, n):
    if case == "unmasked":
        return None
    mask = np.ones((b, n), bool)
    mask[:, 40:] = False
    if case == "masked_index0":
        mask[:, :10] = False
    return mask


@pytest.mark.parametrize("case", ["unmasked", "masked", "masked_index0"])
def test_fps_matches_jax(rng, case):
    pts = _pts(rng, 2, 64 if case != "unmasked" else 300)
    mask = _fps_mask(case, *pts.shape[:2])
    want = jref.farthest_point_sample(
        jnp.asarray(pts), 16, valid_mask=None if mask is None else jnp.asarray(mask)
    )
    got = ops.farthest_point_sample(_t(pts), 16, valid_mask=None if mask is None else _t(mask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if case == "masked_index0":
        assert got[:, 0].tolist() == [10, 10]
    if mask is not None:
        assert mask[np.arange(2)[:, None], got.numpy()].all()


# ---------------------------------------------------------------------------
# Ball query
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["normal", "empty_ball", "masked"])
def test_ball_query_matches_jax(rng, case):
    pts = _pts(rng, 2, 256, scale=1.0)
    centers = pts[:, :32].copy()
    mask = None
    if case == "empty_ball":
        centers[:, :4] = 50.0  # far from everything: nearest-point fallback
    if case == "masked":
        mask = rng.uniform(size=(2, 256)) > 0.3
    jm = None if mask is None else jnp.asarray(mask)
    want_idx, want_cnt = jref.ball_query(jnp.asarray(centers), jnp.asarray(pts), 0.3, 16, valid_mask=jm)
    got_idx, got_cnt = ops.ball_query(_t(centers), _t(pts), 0.3, 16, valid_mask=None if mask is None else _t(mask))
    assert got_idx.dtype == torch.int32 and got_cnt.dtype == torch.int32
    np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(want_cnt))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    if case == "empty_ball":
        assert (got_cnt.numpy()[:, :4] == 0).all()
    if case == "masked":  # masked points only where a ball is empty
        hit = mask[np.arange(2)[:, None, None], got_idx.numpy()]
        assert hit[got_cnt.numpy() > 0].all()


# ---------------------------------------------------------------------------
# kNN
# ---------------------------------------------------------------------------


def _knn_case(rng, case):
    q = _pts(rng, 2, 40)
    r = _pts(rng, 2, 300)
    mask = None
    if case == "ref_mask":
        mask = np.ones((2, 300), bool)
        mask[:, 150:] = False
    elif case == "sentinel":
        r[:, 100:200] = 1e6  # invalid-pixel fill of unproject_views
    elif case == "duplicates":
        base = _pts(rng, 2, 50)
        r = np.concatenate([base, base], axis=1)
        q = base[:, :10] + 1e-7
    return q, r, mask


@pytest.mark.parametrize("case", ["plain", "ref_mask", "sentinel", "duplicates"])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_knn_matches_jax(rng, case, k):
    q, r, mask = _knn_case(rng, case)
    jm = None if mask is None else jnp.asarray(mask)
    want_d, want_i = jref.knn(jnp.asarray(q), jnp.asarray(r), k, ref_mask=jm)
    got_d, got_i = ops.knn(_t(q), _t(r), k, ref_mask=None if mask is None else _t(mask))
    assert got_i.dtype == torch.int32 and got_d.dtype == torch.float32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=1e-5)
    # ascending, and the brute and fusion wrappers agree on the CPU
    assert (np.diff(got_d.numpy(), axis=-1) >= 0).all()
    for wrapper in (knn_brute.knn, knn_bucketed.knn):
        d2, i2 = wrapper(_t(q), reference.mask_points(_t(r), None if mask is None else _t(mask)), k)
        np.testing.assert_array_equal(i2.numpy(), got_i.numpy())
        np.testing.assert_array_equal(d2.numpy(), got_d.numpy())


@pytest.fixture
def small_gated_tiles(monkeypatch):
    """Shrink the gated kernel's tiles so interpret mode walks many tiles."""
    monkeypatch.setattr(pgated, "_TILE_M", 32)
    monkeypatch.setattr(pgated, "_TILE_N", 64)
    monkeypatch.setattr(pgated, "_TILE_N_BIG", 64)


@pytest.mark.parametrize("sentinel", [False, True])
def test_fusion_knn_matches_jax_gated_kernel(rng, small_gated_tiles, sentinel):
    """The port's fusion-scale kNN against the JAX gated (Morton-sorted,
    bound-gated) Pallas kernel in interpret mode. That kernel breaks exact
    ties by visit order, so continuous data and sorted neighbor sets."""
    q = _pts(rng, 1, 100)
    r = _pts(rng, 1, 1000)
    if sentinel:
        r[:, 300:450] = 1e6
    with pltpu.force_tpu_interpret_mode():
        want_d, want_i = pgated.knn(jnp.asarray(q), jnp.asarray(r), 3)
    got_d, got_i = knn_bucketed.knn(_t(q), _t(r), 3)
    np.testing.assert_array_equal(np.sort(got_i.numpy(), -1), np.sort(np.asarray(want_i), -1))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=1e-5)
    if sentinel:
        assert not np.isin(got_i.numpy(), np.arange(300, 450)).any()


def test_three_nn_interpolate_matches_jax(rng):
    dense = _pts(rng, 2, 200)
    sparse = _pts(rng, 2, 30)
    feat = rng.normal(size=(2, 30, 7)).astype(np.float32)
    want = jref.three_nn_interpolate(jnp.asarray(dense), jnp.asarray(sparse), jnp.asarray(feat))
    got = ops.three_nn_interpolate(_t(dense), _t(sparse), _t(feat))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_group_points_matches_jax(rng):
    feats = rng.normal(size=(2, 64, 7)).astype(np.float32)
    idx = rng.integers(0, 64, size=(2, 10, 4)).astype(np.int32)
    want = jref.group_points(jnp.asarray(feats), jnp.asarray(idx))
    got = ops.group_points(_t(feats), _t(idx))  # int32 indices, widened inside
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Lift + batch preparation
# ---------------------------------------------------------------------------


def _views(rng, b=2, v=3, h=12, w=16):
    depth = rng.uniform(0.5, 4.0, (b, v, h, w)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.2] = 0.0  # holes
    poses = np.tile(np.eye(4, dtype=np.float32), (b, v, 1, 1))
    ang = rng.uniform(0, 2 * np.pi, (b, v))
    poses[..., 0, 0], poses[..., 0, 1] = np.cos(ang), -np.sin(ang)
    poses[..., 1, 0], poses[..., 1, 1] = np.sin(ang), np.cos(ang)
    poses[..., :3, 3] = rng.uniform(-1, 1, (b, v, 3))
    fx = 0.6 * w
    intr = np.array([[fx, 0, w / 2], [0, fx * 1.1, h / 2], [0, 0, 1]], np.float32)
    return depth, np.tile(intr, (b, v, 1, 1)), poses


def test_unproject_views_matches_jax(rng):
    depth, intr, poses = _views(rng)
    want_xyz, want_valid = jax_unproject_views(jnp.asarray(depth), jnp.asarray(intr), jnp.asarray(poses))
    got_xyz, got_valid = unproject_views(_t(depth), _t(intr), _t(poses))
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    np.testing.assert_allclose(got_xyz.numpy(), np.asarray(want_xyz), rtol=1e-6, atol=1e-5)
    assert (got_xyz.numpy()[~want_valid] == 1e6).all()


@pytest.mark.parametrize("compact", [False, True])
def test_prepare_batch_matches_jax(rng, compact):
    depth, intr, poses = _views(rng)
    b, v, h, w = depth.shape
    batch = {
        "points": _pts(rng, b, 50),
        "seg_label": rng.integers(0, 5, (b, 50)).astype(np.int32),
        "images": rng.uniform(size=(b, v, h, w, 3)).astype(np.float32),
        "depth": depth,
        "poses": poses,
        "intrinsics": intr[:, 0],
        "seg_label_2d": rng.integers(0, 5, (b, v, h, w)).astype(np.int32),
    }
    if compact:  # the pipeline's wire format
        batch["points"] = np.round(batch["points"] * 1000).astype(np.int16)
        batch["seg_label"] = batch["seg_label"].astype(np.int8)
        batch["images"] = (batch["images"] * 255).astype(np.uint8)
        batch["depth"] = np.round(depth * 1000).astype(np.uint16)
        batch["seg_label_2d"] = batch["seg_label_2d"].astype(np.int8)
    want = jax_prepare_batch(JaxConfig(), {k: jnp.asarray(x) for k, x in batch.items()}, training=False)
    got = prepare_batch(Config(), {k: _t(x) for k, x in batch.items()}, training=False)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-6, atol=1e-5, err_msg=key)
    with pytest.raises(NotImplementedError):
        prepare_batch(Config(), {k: _t(x) for k, x in batch.items()}, training=True)


# ---------------------------------------------------------------------------
# Dispatch, routing and the wrappers' argument checks
# ---------------------------------------------------------------------------


def test_dispatch_modes_on_cpu(rng):
    q, r = _t(_pts(rng, 1, 8)), _t(_pts(rng, 1, 64))
    want = ops.knn(q, r, 3)
    ops.set_impl("reference")
    np.testing.assert_array_equal(ops.knn(q, r, 3)[1].numpy(), want[1].numpy())
    ops.set_impl("cuda")  # a CPU tensor must not quietly take the plain path
    with pytest.raises(RuntimeError):
        ops.knn(q, r, 3)
    with pytest.raises(RuntimeError):
        ops.farthest_point_sample(r, 4)
    with pytest.raises(RuntimeError):
        ops.ball_query(q, r, 0.5, 4)
    with pytest.raises(RuntimeError):
        ops.knn_prepared(q, ops.knn_prepare(r), 3)
    with pytest.raises(ValueError):
        ops.set_impl("pallas")
    # plain versions launch nothing
    assert ops.launch_counts() == {"knn_fusion": 0, "fps": 0, "fps_perrow": 0, "ball_query": 0, "knn": 0}


@pytest.mark.parametrize(
    "m,n,bucketed",
    [(8192, 96000, True), (256, 1 << 15, True), (255, 1 << 15, False), (8192, (1 << 15) - 1, False), (8192, 1024, False)],
)
def test_knn_routing(m, n, bucketed):
    assert knn_bucketed.supported(m, n) == bucketed


@pytest.mark.parametrize("b,m,n,sms", [(1, 8192, 96000, 132), (4, 8192, 57600, 132), (1, 256, 1 << 15, 132), (2, 300, 5000, 8)])
def test_fusion_slicing_covers_refs(b, m, n, sms):
    slices, slice_len = knn_bucketed.slicing(b, m, n, sms)
    assert slices >= 1 and slices * slice_len >= n and (slices - 1) * slice_len < n
    assert slices <= -(-n // 1024)  # no slice shorter than needed to tile


@pytest.mark.parametrize(
    "call",
    [
        lambda q, r: knn_brute.knn(q, r, 9),  # k above the kernel's 8
        lambda q, r: knn_bucketed.knn(q, r, 0),
        lambda q, r: knn_brute.knn(q[..., :2], r, 3),  # not (B, N, 3)
        lambda q, r: knn_brute.knn(q, r[:0], 1),  # batch mismatch
        lambda q, r: fps.farthest_point_sample(r, 4, valid_mask=torch.ones(1, 3, dtype=torch.bool)),
        lambda q, r: ballquery.ball_query(q, r, 0.1, 0),
        lambda q, r: ballquery.ball_query(q, r[:, :4], 0.1, 8),  # more slots than points
    ],
)
def test_wrappers_reject_bad_arguments(rng, call):
    q, r = _t(_pts(rng, 1, 8)), _t(_pts(rng, 1, 64))
    with pytest.raises(ValueError):
        call(q, r)


# ---------------------------------------------------------------------------
# FPS rows too long for shared memory: the per-row kernel's contract
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_fps_long_rows_match_jax_perrow_kernel(rng, masked, monkeypatch):
    """Rows of 20,000 points take fps_perrow on the card; their plain version
    equals the JAX per-row Pallas kernel (_fps_perrow, forced by _MAX_BN = 1
    as tests/test_pallas.py does) in TPU interpret mode, index for index."""
    from mvpnet_tpu.ops.pallas import fps as pfps

    pts = _pts(rng, 2, 20000)
    mask = None
    if masked:
        mask = rng.random((2, 20000)) > 0.2
        mask[0, :7] = False  # the seed moves to the first valid point
    monkeypatch.setattr(pfps, "_MAX_BN", 1)
    with pltpu.force_tpu_interpret_mode():
        want = pfps.farthest_point_sample(jnp.asarray(pts), 256, valid_mask=None if mask is None else jnp.asarray(mask))
    got = ops.farthest_point_sample(_t(pts), 256, valid_mask=None if mask is None else _t(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert fps.route(20000, H100_SHARED_BYTES) == "fps_perrow"
    if masked:
        assert got[0, 0].item() == 7 and mask[np.arange(2)[:, None], got.numpy()].all()


# dynamic shared memory a block may opt in to on an H100: 227 KB
H100_SHARED_BYTES = 232448


@pytest.mark.parametrize(
    "n,kernel",
    [(102400, "fps_perrow"), (16384, "fps_perrow"), (8192, "fps"), (1024, "fps"),
     (H100_SHARED_BYTES // 16, "fps"), (H100_SHARED_BYTES // 16 + 1, "fps_perrow")],
)
def test_fps_route(n, kernel):
    """SA1 at the high-resolution config (102,400) and at its reduced depth
    (16,384) take the per-row kernel; chunk-path rows the shared-memory one."""
    assert fps.route(n, H100_SHARED_BYTES) == kernel


def test_knn_prepared_matches_knn(rng):
    q, r = _pts(rng, 1, 300), _pts(rng, 1, 5000)
    prepared = ops.knn_prepare(_t(r))
    got_d, got_i = ops.knn_prepared(_t(q), prepared, 3)
    want_d, want_i = ops.knn(_t(q), _t(r), 3)
    assert torch.equal(got_i, want_i) and torch.equal(got_d, want_d)
    from mvpnet_tpu import ops as jops

    jd, ji = jops.knn_prepared(jnp.asarray(q), jops.knn_prepare(jnp.asarray(r)), 3)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(jd), atol=1e-5)
