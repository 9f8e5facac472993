"""The port's point ops (mvpnet_torch.ops, plain versions on the CPU) against
the JAX package's: the jnp reference, and the gated Pallas kNN in TPU
interpret mode.

Inputs are made from a numpy seed and fed to both packages. Indices must be
equal on continuous random geometry (ties are measure-zero there, apart from
the deliberate duplicate-point case, where both break them to the lower
index). Distances agree within 1e-5 absolute: the JAX reference expands
|a|^2 - 2ab + |b|^2 while the port (and the kernels) compute (a - b)^2.
"""
import dataclasses

import numpy as np
import jax
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
from mvpnet_torch.ops import ballquery, fps, knn_bucketed, knn_gated, knn_resident, morton, reference
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
    """tests/test_pallas.py's small tiles for the JAX gated and VMEM kernels,
    so interpret mode walks many tiles."""
    monkeypatch.setattr(pgated, "_TILE_M", 32)
    monkeypatch.setattr(pgated, "_TILE_N", 64)
    monkeypatch.setattr(pgated, "_TILE_N_BIG", 64)
    monkeypatch.setattr(pgated, "_VMEM_TILE_M", 32)
    monkeypatch.setattr(pgated, "_VMEM_TILE_N", 64)


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
    # training without augmentation prepares the same batch
    no_aug = dataclasses.replace(Config(), data=dataclasses.replace(Config().data, augment=False))
    train = prepare_batch(no_aug, {k: _t(x) for k, x in batch.items()}, training=True, generator=torch.Generator())
    for key in want:
        assert torch.equal(train[key], got[key]), key


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
    assert ops.launch_counts() == {
        "knn_fusion": 0, "fps": 0, "fps_perrow": 0, "ball_query": 0, "knn": 0, "knn_gated": 0, "knn_resident": 0,
        "morton_prep": 0,
    }


def _op_calls(rng):
    """Each public op on small CPU inputs, as a function of ``impl``."""
    q, r = _t(_pts(rng, 2, 12)), _t(_pts(rng, 2, 64))
    feat = _t(rng.normal(size=(2, 64, 5)).astype(np.float32))
    prepared = ops.knn_prepare(r, impl="reference")
    return {
        "knn": lambda impl: ops.knn(q, r, 3, impl=impl),
        "farthest_point_sample": lambda impl: ops.farthest_point_sample(r, 8, impl=impl),
        "ball_query": lambda impl: ops.ball_query(q, r, 0.8, 4, impl=impl),
        "three_nn_interpolate": lambda impl: ops.three_nn_interpolate(q, r, feat, impl=impl),
        "knn_prepare": lambda impl: ops.knn_prepare(r, impl=impl).refs,
        "knn_prepared": lambda impl: ops.knn_prepared(q, prepared, 3, impl=impl),
    }


OPS = ("knn", "farthest_point_sample", "ball_query", "three_nn_interpolate", "knn_prepare", "knn_prepared")


@pytest.mark.parametrize("op", OPS)
def test_per_call_impl(rng, op):
    """A call's impl= overrides the module's setting for that call alone:
    "reference" equals set_impl("reference"), "cuda" on a CPU tensor raises,
    and the module's setting is left as it was."""
    call = _op_calls(rng)[op]
    ops.set_impl("reference")
    want = call(None)
    ops.set_impl("cuda")
    got = call("reference")
    assert ops.get_impl() == "cuda"
    for g, w in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, want))):
        assert torch.equal(g, w)
    ops.set_impl("auto")
    with pytest.raises(ValueError):
        call("pallas")
    with pytest.raises(RuntimeError):
        call("cuda")
    assert ops.get_impl() == "auto" and not any(ops.launch_counts().values())


def test_knn_refs_coherent_is_a_hint(rng):
    q, r = _t(_pts(rng, 2, 30)), _t(_pts(rng, 2, 200))
    want = ops.knn(q, r, 3)
    for impl in (None, "reference"):
        got = ops.knn(q, r, 3, impl=impl, refs_coherent=True)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("op", OPS)
def test_op_signatures_match_jax(op):
    """The port's public ops take the JAX package's parameters, by name and
    in order."""
    import inspect

    import mvpnet_tpu.ops as jops

    assert list(inspect.signature(getattr(ops, op)).parameters) == list(inspect.signature(getattr(jops, op)).parameters)


def test_get_impl_round_trips():
    for name in ("reference", "cuda", "auto"):
        ops.set_impl(name)
        assert ops.get_impl() == name


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
        lambda q, r: knn_bucketed.knn(q, r, 3, mode="gated"),  # no such mode
        lambda q, r: fps.farthest_point_sample(r, 0),  # npoint below 1
        lambda q, r: knn_brute.knn_at(q, r, 3, 1, 1, 64),  # a launch at a given layout needs the card
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


@pytest.mark.parametrize("n", [14529, 16384, 102400, 1 << 19])
@pytest.mark.parametrize(
    "shared",
    # the H100's opt-in limit, and the portable 48 KB, each less the kernels'
    # static shared memory
    [H100_SHARED_BYTES - 2048, 48 * 1024 - 2048],
    ids=["h100", "48k"],
)
def test_fps_cluster_split(n, shared):
    """fps_perrow's slices: contiguous and ascending over [0, n), each split
    into registers, then shared memory, then the device-memory overflow,
    which only rows too long for the cluster's chip memory have."""
    slice_len, smem_points, slices = fps.cluster_split(n, shared)
    assert len(slices) == fps.CLUSTER and slice_len * fps.CLUSTER >= n
    assert slices[0].start == 0 and slices[-1].stop == n
    assert all(a.stop == b.start for a, b in zip(slices, slices[1:]))
    on_regs = fps.REG_POINTS * fps.CLUSTER_THREADS
    assert 0 <= smem_points and fps.ROW_BYTES * smem_points <= shared
    for s in slices:
        assert s.regs + s.shared + s.overflow == s.stop - s.start <= slice_len
        assert s.regs == min(s.stop - s.start, on_regs) and s.shared <= smem_points
        assert (s.overflow > 0) == (s.stop - s.start > on_regs + shared // fps.ROW_BYTES)
    overflow = sum(s.overflow for s in slices)
    if n == 1 << 19:  # the TPU wrapper's longest row spills
        assert overflow > 0
    else:
        assert overflow == 0
    if n == 102400:  # SA1 at the high-resolution config: all in registers
        assert smem_points == 0 and all(s.regs == 6400 for s in slices)


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


# ---------------------------------------------------------------------------
# The gated fusion kNN variants: Morton prep, rows 6 and 7, variant choice
# ---------------------------------------------------------------------------


def _variant_case(rng, case):
    """(queries, refs) of one of the variant tests' cases."""
    q = _pts(rng, 2, 100)
    r = _pts(rng, 2, 1000)
    if case == "sentinel":
        r[:, 300:450] = 1e6  # a block of invalid pixels
        r[:, ::7] = 1e6  # and scattered ones
    elif case == "masked":
        r[:, 600:] = reference.MASK_COORD  # ops.knn's ref_mask fill
    elif case == "duplicates":  # equal distances: ties follow the visit order
        base = _pts(rng, 2, 500)
        r = np.concatenate([base, base], axis=1)
        q = base[:, :100] + 1e-7
    return q, r


@pytest.mark.parametrize("case", ["plain", "sentinel", "duplicates"])
def test_morton_prepare_matches_jax(rng, case):
    """Every output of the ported prep equals JAX's _prepare exactly: the two
    stable sorts (Morton order, lb visit order), the padded clouds and the
    bounds."""
    q, r = _variant_case(rng, case)
    want = pgated._prepare(jnp.asarray(q), jnp.asarray(r), 32, 64)
    got = morton.prepare(_t(q), _t(r), 32, 64)
    for name, w, g in [("q_sorted", want[0], got.q_sorted), ("r_sorted", want[1], got.r_sorted),
                       ("q_order", want[2], got.q_order), ("r_order", want[3], got.r_order),
                       ("order", want[4], got.order), ("lb_sorted", want[5], got.lb_sorted)]:
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert (want[6], want[7]) == (got.q_sorted.shape[1], got.r_sorted.shape[1])
    inv = morton.inverse_perm(got.q_order)
    np.testing.assert_array_equal(inv.numpy(), np.asarray(pgated._inverse_perm(want[2])))


# distances: the JAX kernel's dx*dx + dy*dy + dz*dz may contract into FMAs in
# interpret mode; the port rounds each op (the CUDA kernels' form), ~1 ulp
GATED_ATOL = 1e-6


@pytest.mark.parametrize("case", ["plain", "sentinel", "masked", "duplicates"])
def test_gated_plain_matches_jax_gated_kernel(rng, small_gated_tiles, case):
    """Row 6's plain version equals JAX's _knn_forward (_gated_kernel, TPU
    interpret mode) index for index, visit-order ties included."""
    q, r = _variant_case(rng, case)
    with pltpu.force_tpu_interpret_mode():
        want_d, want_i = pgated._knn_forward(jnp.asarray(q), jnp.asarray(r), 3)
    got_d, got_i = morton.gated_plain(_t(q), _t(r), 3, 32, 64)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=GATED_ATOL, rtol=1e-6)
    if case != "plain":
        assert not np.isin(got_i.numpy(), np.arange(600, 1000) if case == "masked" else np.arange(300, 450)).any() \
            or case == "duplicates"


def test_gated_plain_matches_jax_subgroup_gate(rng, small_gated_tiles, monkeypatch):
    """The big-N body (8-row subgroup gates over real-coordinate boxes),
    forced at small N: both sides switch at _BIG_N."""
    monkeypatch.setattr(pgated, "_BIG_N", 512)
    monkeypatch.setattr(morton, "BIG_N", 512)
    monkeypatch.setattr(morton, "TILE_M", 32)
    monkeypatch.setattr(morton, "TILE_N_BIG", 64)
    q = _pts(rng, 1, 64)
    r = _pts(rng, 1, 640)
    r[:, ::5] = 1e6
    with pltpu.force_tpu_interpret_mode():
        want_d, want_i = pgated._knn_forward(jnp.asarray(q), jnp.asarray(r), 3)
    assert knn_gated.tiles(64, 640) == (32, 64, True)
    got_d, got_i = knn_gated.knn(_t(q), _t(r), 3)  # a CPU tensor: the plain version
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=GATED_ATOL, rtol=1e-6)


@pytest.mark.parametrize("case", ["plain", "duplicates"])
def test_resident_plain_matches_jax_vmem_kernel(rng, small_gated_tiles, case):
    """Row 7's plain version equals JAX's _knn_forward_demand(use_vmem=True)
    (_vmem_kernel, TPU interpret mode) index for index."""
    q, r = _variant_case(rng, case)
    with pltpu.force_tpu_interpret_mode():
        want_d, want_i = pgated._knn_forward_demand(jnp.asarray(q), jnp.asarray(r), 3, use_vmem=True)
    got_d, got_i = morton.gated_plain(_t(q), _t(r), 3, 32, 64)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=GATED_ATOL, rtol=1e-6)


@pytest.mark.parametrize("case", ["plain", "sentinel", "duplicates"])
def test_morton_prepare_unsorted_refs_matches_jax(rng, case):
    """prepare(sort_refs=False) equals JAX's _prepare(sort_refs=False): the
    refs in their order (no r_order), padded, the tile boxes over their real
    points, the visit order and bounds."""
    q, r = _variant_case(rng, case)
    want = pgated._prepare(jnp.asarray(q), jnp.asarray(r), 32, 64, sort_refs=False)
    got = morton.prepare(_t(q), _t(r), 32, 64, sort_refs=False)
    assert want[3] is None and got.r_order is None
    for name, w, g in [("q_sorted", want[0], got.q_sorted), ("r_sorted", want[1], got.r_sorted),
                       ("q_order", want[2], got.q_order), ("order", want[4], got.order),
                       ("lb_sorted", want[5], got.lb_sorted)]:
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_array_equal(got.r_sorted[:, :1000].numpy(), r)


@pytest.mark.parametrize("sort_refs", [True, False])
def test_morton_unmap_matches_jax(rng, sort_refs):
    """The plain chain's un-mapping (sorted rows and columns back to the
    original queries and refs, padding columns clamped) equals JAX's _unmap."""
    q, r = _variant_case(rng, "plain")
    p = morton.prepare(_t(q), _t(r), 32, 64, sort_refs)
    M_pad, N_pad = p.q_sorted.shape[1], p.r_sorted.shape[1]
    d_s = rng.uniform(size=(2, M_pad, 3)).astype(np.float32)
    i_s = rng.integers(0, N_pad, size=(2, M_pad, 3)).astype(np.int32)
    got_d, got_i = morton.unmap(_t(d_s), _t(i_s), p.q_order, p.r_order, 100, 1000)
    r_order = None if p.r_order is None else jnp.asarray(p.r_order.numpy().astype(np.int32))
    want_d, want_i = pgated._unmap(jnp.asarray(d_s), jnp.asarray(i_s), jnp.asarray(p.q_order.numpy().astype(np.int32)),
                                   r_order, 100, 1000)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def _coherent_tie_case(rng, n_refs=128):
    """32 queries in [0, 0.1]^3 over refs in tiles of 64 where the point
    (0.05, 0.05, 1.0) is ref 0 and ref 64: tile 0's other refs at (6, 6, 6),
    tile 1's at x in [-5, -4], y = 0.05, z in [0.9, 1.0], so that tile 1 has
    the lower bound (0.64 against 0.81); refs past 128 lie far away. With the
    refs in their order the search visits tile 1 first and the tie goes to
    ref 64; Morton-sorted, both land in one tile and ref 0 comes first."""
    q = rng.uniform(0, 0.1, size=(1, 32, 3)).astype(np.float32)
    r = rng.uniform(50, 60, size=(1, n_refs, 3)).astype(np.float32)
    r[0, :64] = 6.0
    r[0, 64:128, 0] = rng.uniform(-5, -4, size=64)
    r[0, 64:128, 1] = 0.05
    r[0, 64:128, 2] = rng.uniform(0.9, 1.0, size=64)
    r[0, [0, 64]] = (0.05, 0.05, 1.0)
    return q, r


@pytest.mark.parametrize("variant", ["gated", "resident"])
def test_refs_coherent_keeps_the_refs_order(rng, small_gated_tiles, monkeypatch, variant):
    """refs_coherent / sort_refs=False skips the ref-side sort, as JAX's
    knn(..., refs_coherent=True) does (_USE_DEMAND False for row 6,
    use_vmem=True for row 7, both in interpret mode): the visit order and so
    the winner of an exact tie change (ref 64, not 0), and the port's plain
    version and the kernel's schedule follow it."""
    monkeypatch.setattr(pgated, "_USE_DEMAND", False)
    for name, value in [("TILE_M", 32), ("TILE_N", 64), ("VMEM_TILE_M", 32), ("VMEM_TILE_N", 64)]:
        monkeypatch.setattr(morton, name, value)
    q, r = _coherent_tie_case(rng)
    mod = knn_gated if variant == "gated" else knn_resident
    for sort_refs, winner in [(False, 64), (True, 0)]:
        with pltpu.force_tpu_interpret_mode():
            if variant == "gated":
                want_d, want_i = pgated.knn(jnp.asarray(q), jnp.asarray(r), 1, refs_coherent=not sort_refs)
            else:
                want_d, want_i = pgated._knn_forward_demand(jnp.asarray(q), jnp.asarray(r), 1, sort_refs=sort_refs,
                                                            use_vmem=True)
        got_d, got_i = mod.knn(_t(q), _t(r), 1, sort_refs=sort_refs)  # a CPU tensor: the plain version
        assert (np.asarray(want_i) == winner).all() and (got_i.numpy() == winner).all()
        np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=GATED_ATOL, rtol=1e-6)
        emu_d, emu_i, _ = knn_gated.split_emulation(_t(q), _t(r), 1, 32, 64, 4, 32, first_always=variant == "gated",
                                                    sort_refs=sort_refs)
        assert torch.equal(emu_i, got_i) and torch.equal(emu_d, got_d)


@pytest.mark.parametrize("variant", ["gated", "resident"])
def test_knn_refs_coherent_reaches_the_gated_variants(rng, monkeypatch, variant):
    """ops.knn passes refs_coherent to the "gated" and "resident" variants at
    a fusion-size search (256 queries over 2^15 refs), where it decides the
    tie; the default variant takes the lower index either way."""
    for name, value in [("TILE_M", 32), ("TILE_N", 64), ("VMEM_TILE_M", 32), ("VMEM_TILE_N", 64)]:
        monkeypatch.setattr(morton, name, value)
    q, r = _coherent_tie_case(rng, 1 << 15)
    q = np.concatenate([q] * 8, axis=1)
    try:
        ops.set_fusion_variant(variant)
        assert (ops.knn(_t(q), _t(r), 1, refs_coherent=True)[1] == 64).all()
        assert (ops.knn(_t(q), _t(r), 1)[1] == 0).all()
    finally:
        ops.set_fusion_variant("demand")
    assert (ops.knn(_t(q), _t(r), 1, refs_coherent=True)[1] == 0).all()


def test_prepare_device_needs_the_card(rng):
    q, r = _variant_case(rng, "plain")
    with pytest.raises(ValueError, match="CUDA"):
        morton.prepare_device(_t(q), _t(r), 32, 64)
    for mod in (knn_gated, knn_resident):
        with pytest.raises(ValueError, match="CUDA"):
            mod.knn_at(_t(q), _t(r), 3, 4, 32)
    assert ops.launch_counts()["morton_prep"] == 0


def test_gated_plain_rows_subset(rng):
    """``rows`` picks original queries out of the full search (what the card
    check compares at full shape)."""
    q, r = _pts(rng, 2, 300), _pts(rng, 2, 3000)
    full = morton.gated_plain(_t(q), _t(r), 3, 64, 256)
    rows = torch.tensor([0, 7, 299, 150])
    part = morton.gated_plain(_t(q), _t(r), 3, 64, 256, rows=rows, block_elems=2 * 4096 * 3)
    assert torch.equal(part[0], full[0][:, rows]) and torch.equal(part[1], full[1][:, rows])


def test_fusion_variant_selection(rng):
    q, r = _t(_pts(rng, 1, 256)), _t(_pts(rng, 1, 1 << 15))
    want = ops.knn(q, r, 3)
    try:
        for name, mod in [("gated", knn_gated), ("resident", knn_resident)]:
            ops.set_fusion_variant(name)
            got = ops.knn(q, r, 3)  # the CPU: the variant's plain version
            assert torch.equal(got[1], mod.plain(q, r, 3)[1])
            assert torch.equal(got[1], want[1])  # no ties in continuous data
        with pytest.raises(ValueError):
            ops.set_fusion_variant("vmem")
    finally:
        ops.set_fusion_variant("demand")
    with pytest.raises(ValueError, match="resident"):
        knn_resident.knn(q, _t(_pts(rng, 1, morton.VMEM_N_MAX + 1)), 3)
    assert knn_resident.tiles(8192) == (64, 1024) and knn_gated.tiles(8192, 57600) == (256, 2048, False)
    assert knn_gated.tiles(102400, 1228800) == (256, 8192, True)
    assert ops.launch_counts()["knn_gated"] == 0 and ops.launch_counts()["knn_resident"] == 0


# ---------------------------------------------------------------------------
# Row 1: the demand-gated fusion kNN (csrc/knn_fusion.cu, knn_fusion_demand)
# ---------------------------------------------------------------------------

INT_MAX = 2**31 - 1


def _demand_emulation(queries, refs, k, tile_m, tile_n, sub_gate, query_box=True):
    """Row 1's demand mode in plain PyTorch: the kernel's prep, visit order,
    gates (a tile is scanned unless its bound exceeds the block's worst k-th
    distance over its real rows; the first closed gate ends the loop; with
    ``sub_gate`` each 8-row group also skips a tile whose box bound exceeds
    its own worst) and lists ordered by (distance, original index). Returns
    (d, i) in the original query order and the (row, ref) pairs scanned."""
    B, M, _ = queries.shape
    q = queries.float()
    box = (q.amin(1, keepdim=True), q.amax(1, keepdim=True)) if query_box else (None, None)
    p = morton.prepare_refs(refs, tile_n, *box)
    q_sorted, q_order, order, lb = morton.prepare_queries(queries, p, tile_m)
    N, N_pad, M_pad = p.n, p.r4.shape[1], q_sorted.shape[1]
    Nt, Mt, G = N_pad // tile_n, M_pad // tile_m, tile_m // morton.SUB
    r_xyz, r_idx = p.r4[..., :3], p.r4[..., 3].view(torch.int32).long()
    qt = q_sorted.reshape(B, Mt, tile_m, 3)
    real = (torch.arange(M_pad) < M).reshape(1, Mt, tile_m)
    inf = torch.tensor(float("inf"))
    best_d = torch.full((B, Mt, tile_m, k), float("inf"))
    best_i = torch.full((B, Mt, tile_m, k), INT_MAX, dtype=torch.long)
    worst = torch.full((B, Mt), float("inf"))
    running = torch.ones((B, Mt), dtype=torch.bool)
    scanned = 0
    for t in range(Nt):
        running &= ~(lb[..., t] > worst)  # the first closed gate ends the loop
        if not running.any():
            break
        cols = order[..., t].long()[..., None] * tile_n + torch.arange(tile_n)  # (B, Mt, tile_n)
        rt = torch.gather(r_xyz, 1, cols.reshape(B, -1, 1).expand(-1, -1, 3)).reshape(B, Mt, tile_n, 3)
        it = torch.gather(r_idx, 1, cols.reshape(B, -1)).reshape(B, Mt, 1, tile_n)
        scan = running[..., None, None] & (cols < N)[:, :, None, :]  # padding is never a candidate
        if sub_gate:
            qg = qt.reshape(B, Mt, G, morton.SUB, 3)
            rg = real.reshape(1, Mt, G, morton.SUB, 1)
            glo = torch.where(rg, qg, inf).amin(3).reshape(-1, 1, 3)
            ghi = torch.where(rg, qg, -inf).amax(3).reshape(-1, 1, 3)
            tb = torch.gather(p.boxes, 1, order[..., t].long()[..., None].expand(-1, -1, 12))
            tb = tb[:, :, None, :].expand(-1, -1, G, -1).reshape(-1, 1, 12)  # each group's tile
            lb_sub = torch.minimum(
                morton.box_sqdist(glo, ghi, tb[..., 0:3], tb[..., 3:6]), morton.box_sqdist(glo, ghi, tb[..., 6:9], tb[..., 9:12])
            ).reshape(B, Mt, G)
            kth = torch.where(real, best_d[..., k - 1], -inf).reshape(B, Mt, G, morton.SUB).amax(-1)
            group_scan = ~(lb_sub > kth)
            scan = scan & group_scan.repeat_interleave(morton.SUB, dim=2)[..., None]
        scanned += int(scan.expand(-1, -1, tile_m, -1).sum())
        d = reference.sqdist(qt, rt)  # (B, Mt, tile_m, tile_n)
        cand_d = torch.cat([best_d, torch.where(scan, d, inf)], -1)
        cand_i = torch.cat([best_i, torch.where(scan, it.expand_as(d), INT_MAX)], -1)
        by_i = torch.argsort(cand_i, dim=-1, stable=True)  # (distance, index) order: index, then a stable sort by distance
        cand_d, cand_i = torch.gather(cand_d, -1, by_i), torch.gather(cand_i, -1, by_i)
        by_d = torch.argsort(cand_d, dim=-1, stable=True)[..., :k]
        best_d, best_i = torch.gather(cand_d, -1, by_d), torch.gather(cand_i, -1, by_d)
        worst = torch.where(running, torch.where(real, best_d[..., k - 1], -inf).amax(-1), worst)
    inv = morton.inverse_perm(q_order)[..., None].expand(-1, -1, k)
    d = torch.gather(best_d.reshape(B, M_pad, k)[:, :M], 1, inv)
    i = torch.gather(best_i.reshape(B, M_pad, k)[:, :M], 1, inv).to(torch.int32)
    return d, i, scanned


def _demand_case(rng, case):
    """(queries, refs) of a room-like cloud: points on the faces of a 4 m
    box, the queries near them."""

    def faces(n):
        p = rng.uniform(0, 4, size=(2, n, 3)).astype(np.float32)
        face = rng.integers(0, 3, size=(2, n))
        np.put_along_axis(p, face[..., None], rng.integers(0, 2, size=(2, n, 1)) * 4.0, axis=-1)
        return p

    q = faces(100) + rng.normal(0, 0.02, size=(2, 100, 3)).astype(np.float32)
    r = faces(1000)
    if case == "duplicates":  # exact ties: the lower index wins
        r[:, 500:] = r[:, :500]
        q[:, :20] = r[:, 600:620]
    elif case == "sentinels":
        r[:, 300:450] = 1e6  # a block of invalid pixels
        r[:, ::7] = 1e6  # and scattered ones
    elif case == "fewer_than_k":  # row 0 has 2 real refs: the rest tie at 1e6 / 1e9
        r[0] = 1e6
        r[0, 1::5] = reference.MASK_COORD
        r[0, [17, 900]] = q[0, :2]
    elif case == "masked":
        r[:, rng.uniform(size=1000) < 0.4] = reference.MASK_COORD  # ops.knn's ref_mask fill
    return q, r


@pytest.mark.parametrize("case", ["continuous", "duplicates", "sentinels", "fewer_than_k", "masked"])
@pytest.mark.parametrize("sub_gate", [False, True], ids=["tile_gate", "sub_gate"])
@pytest.mark.parametrize("query_box", [True, False], ids=["knn", "knn_prepared"])
def test_demand_gate_emulation_matches_plain(rng, case, sub_gate, query_box):
    """Row 1's gate with the (distance, index) order and lb > worst equals
    the plain version (reference.knn) exactly, index ties included, on
    small tiles that make it walk many (16 rows x 64 refs); and it skips
    work on continuous data."""
    q, r = _demand_case(rng, case)
    k = 3
    want_d, want_i = reference.knn(_t(q), _t(r), k)
    got_d, got_i, scanned = _demand_emulation(_t(q), _t(r), k, 16, 64, sub_gate, query_box)
    assert torch.equal(got_i, want_i) and torch.equal(got_d, want_d)
    if case == "continuous":
        assert scanned < 0.9 * 2 * 112 * 1000
    if case == "fewer_than_k":
        assert got_i[0, :, :2].sort(-1).values.tolist() == [[17, 900]] * 100
        assert (got_i[0, :, 2] == 0).all()  # the lowest-index sentinel at 1e6


def _lattice_case(rng, case):
    if case == "random":
        return _pts(rng, 2, 200), np.concatenate([_pts(rng, 2, 900), np.full((2, 100, 3), 1e6, np.float32)], 1)
    # points on a 0.25 m lattice: many lie on the faces of the tile boxes,
    # where the bound equals a distance exactly
    q = rng.integers(-8, 8, size=(2, 200, 3)).astype(np.float32) * 0.25
    r = rng.integers(-8, 8, size=(2, 1000, 3)).astype(np.float32) * 0.25
    r[:, ::9] = reference.MASK_COORD
    return q, r


@pytest.mark.parametrize("case", ["random", "lattice"])
@pytest.mark.parametrize("query_box", [True, False], ids=["query_box", "ref_box"])
def test_demand_bounds_hold_for_every_pair(rng, case, query_box):
    """lb <= d in f32 for every (real query, ref) pair of a (query tile, ref
    tile): the visit list's bounds and the 8-row sub-gate's, sentinel refs
    included, on random and lattice geometry."""
    q, r = _lattice_case(rng, case)
    tile_m, tile_n = 16, 64
    tq, tr = _t(q), _t(r)
    box = (tq.amin(1, keepdim=True), tq.amax(1, keepdim=True)) if query_box else (None, None)
    p = morton.prepare_refs(tr, tile_n, *box)
    q_sorted, _, order, lb = morton.prepare_queries(tq, p, tile_m)
    B, M_pad, N_pad, N, M = 2, q_sorted.shape[1], p.r4.shape[1], r.shape[1], q.shape[1]
    Mt, Nt = M_pad // tile_m, N_pad // tile_n
    d = reference.sqdist(q_sorted, p.r4[..., :3])  # (B, M_pad, N_pad)
    d[:, M:] = float("inf")
    d[:, :, N:] = float("inf")
    tile_min = d.reshape(B, Mt, tile_m, Nt, tile_n).amin(dim=(2, 4))  # (B, Mt, Nt)
    assert (lb <= torch.gather(tile_min, 2, order.long())).all()
    assert (lb == torch.gather(tile_min, 2, order.long())).any() or case == "random"
    # the sub-gate: each 8-row group's box against both boxes of each tile
    G = M_pad // morton.SUB
    real = (torch.arange(M_pad) < M).reshape(1, G, morton.SUB, 1)
    qg = q_sorted.reshape(B, G, morton.SUB, 3)
    glo = torch.where(real, qg, float("inf")).amin(2)
    ghi = torch.where(real, qg, float("-inf")).amax(2)
    b = p.boxes
    lb_sub = torch.minimum(morton.box_sqdist(glo, ghi, b[..., 0:3], b[..., 3:6]), morton.box_sqdist(glo, ghi, b[..., 6:9], b[..., 9:12]))
    group_min = d.reshape(B, G, morton.SUB, Nt, tile_n).amin(dim=(2, 4))
    assert (lb_sub <= group_min).all()


@pytest.mark.parametrize("case", ["plain", "sentinel", "duplicates", "big_tiles"])
def test_knn_prepare_matches_jax_prepare_refs(rng, case, monkeypatch):
    """The prepared cloud (knn_bucketed.prepare, what ops.knn_prepare returns
    on the card) equals JAX's prepare_refs: the stable Morton order by the
    refs' real box (the original indices the 4th coordinate carries), the
    sorted padded coordinates and the real tile boxes."""
    q, r = _variant_case(rng, case if case != "big_tiles" else "sentinel")
    if case == "big_tiles":  # 4096-ref tiles from BIG_N refs up, on both sides
        monkeypatch.setattr(pgated, "_BIG_N", 512)
        monkeypatch.setattr(morton, "BIG_N", 512)
    want = pgated.prepare_refs(jnp.asarray(r))
    got = knn_bucketed.prepare(_t(r))
    assert (got.n, got.tile_n) == (want.n, want.tile_n) == (1000, 4096 if case == "big_tiles" else 2048)
    index = got.r4[..., 3].view(torch.int32)
    np.testing.assert_array_equal(index[:, : got.n].numpy(), np.asarray(want.r_order))
    assert (index[:, got.n :] == -1).all()
    np.testing.assert_array_equal(got.r4[..., :3].numpy(), np.swapaxes(np.asarray(want.rT4), 1, 2)[..., :3])
    np.testing.assert_array_equal(got.boxes[..., 0:3].numpy(), np.asarray(want.rlo))
    np.testing.assert_array_equal(got.boxes[..., 3:6].numpy(), np.asarray(want.rhi))


@pytest.mark.parametrize(
    "b,m,n,mode",
    [(1, 8192, 96000, "brute"), (8, 8192, 57600, "brute"), (4, 102400, 1228800, "demand"), (1, 409600, 230400, "demand"),
     (4, 8192, 153600, "demand"), (4, 16384, 153600, "demand"), (8, 32768, 57600, "demand"),
     (2, 102400, 153600, "demand")],
    ids=["chunk", "train", "scene", "scene_fused", "crossover_5e9", "scene_reduced", "train_32k_chunks", "train_highres"],
)
def test_fusion_mode_route(b, m, n, mode):
    """The fusion kNN's mode on the port's paths and at the searches between
    them: the smallest crossover shape of chip_smoke.py, the reduced-depth
    scene check, and the train
    microbatches of configs/scannet/mvpnet_3d_32k_chunks.yaml and
    mvpnet_3d_highres_64view.yaml (the crossover is measured on the H100:
    PERF.md)."""
    assert knn_bucketed.route(b, m, n) == mode


def _jax_knn_loss(q, r, k):
    from mvpnet_tpu import ops as jops

    d, _ = jops.knn(q, r, k)
    return jnp.sum(jnp.sin(d))


@pytest.mark.parametrize("prepared", [False, True], ids=["knn", "knn_prepared"])
@pytest.mark.parametrize("variant", ["demand", "gated"])
def test_knn_grads_match_jax(rng, prepared, variant):
    """d/dq and d/dr of sum(sin(d)) through the port's kNN autograd equal
    jax.grad through the JAX knn (its analytic custom VJP). Duplicate refs
    make index_add_ add up."""
    q = _pts(rng, 1, 300)
    r = np.concatenate([_pts(rng, 1, 1 << 14)] * 2, axis=1)  # 2^15 refs: the fusion route
    gq_want, gr_want = jax.grad(_jax_knn_loss, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(r), 3)
    tq, tr = _t(q).requires_grad_(), _t(r).requires_grad_()
    ops.set_fusion_variant(variant)
    try:
        d, i = ops.knn_prepared(tq, ops.knn_prepare(tr), 3) if prepared else ops.knn(tq, tr, 3)
    finally:
        ops.set_fusion_variant("demand")
    assert not i.requires_grad
    torch.sin(d).sum().backward()
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(gq_want), atol=1e-4)
    np.testing.assert_allclose(tr.grad.numpy(), np.asarray(gr_want), atol=1e-4)
