"""The port's host data path (mvpnet_torch.data) against the JAX package's.

The port keeps its own copies of the JAX package's jax-free host modules, so
the same seeds and inputs must give the same arrays: every comparison here
is exact (values and dtypes), with no tolerance. Both packages build the
same native grid index (``native/host_index.cpp``), so their box queries
return the same indices in the same order; the NumPy path returns the same
set in index order.
"""
import collections
import dataclasses
import pathlib

import jax
import numpy as np
import pytest
import torch

from mvpnet_tpu.data import meta as jmeta
from mvpnet_tpu.data import native as jnative
from mvpnet_tpu.data import pipeline as jpipeline
from mvpnet_tpu.data import synthetic as jsynthetic
from mvpnet_tpu.data import view_select as jview_select
from mvpnet_torch import config as port_config
from mvpnet_torch.data import meta, native, pipeline, synthetic, view_select
from tests.test_pipeline import small_data_cfg

SCENE = dict(num_points=20000, num_frames=10, height=24, width=32, num_classes=5)


@pytest.fixture(scope="module")
def scenes():
    return jsynthetic.make_scene(3, **SCENE), synthetic.make_scene(3, **SCENE)


def _port_data_cfg(jcfg):
    return port_config._merge_dataclass(port_config.DataConfig(), port_config.to_dict(jcfg))


def _assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_make_scene_matches_jax(scenes):
    jscene, scene = scenes
    assert scene.name == jscene.name
    for f in dataclasses.fields(jscene):
        if f.name in ("name", "extra"):
            continue
        want, got = getattr(jscene, f.name), getattr(scene, f.name)
        assert got.dtype == want.dtype, f.name
        np.testing.assert_array_equal(got, want, err_msg=f.name)


@pytest.mark.parametrize("compact", [True, False], ids=["compact", "float32"])
@pytest.mark.parametrize("seeded", [False, True], ids=["eval", "train"])
def test_make_chunk_sample_matches_jax(scenes, compact, seeded):
    jscene, scene = scenes
    # 6 candidate frames of 10: view selection scores a subset of the frames
    jcfg = small_data_cfg(compact_transfer=compact, num_points=512, max_candidate_frames=6)
    cfg = _port_data_cfg(jcfg)
    kw = dict(center_xy=np.array([2.0, 1.5]), num_views=3)
    want = jpipeline.make_chunk_sample(jscene, jcfg, rng=np.random.default_rng(7) if seeded else None, **kw)
    got = pipeline.make_chunk_sample(scene, cfg, rng=np.random.default_rng(7) if seeded else None, **kw)
    _assert_same(got, want)
    if compact:
        assert got["images"].dtype == np.uint8 and got["points"].dtype == np.int16
    batch = pipeline.collate([got, got])
    _assert_same(batch, jpipeline.collate([want, want]))
    assert batch["depth"].shape == (2, 3, 24, 32)


@pytest.mark.parametrize("candidates", [None, np.array([9, 2, 5, 7])], ids=["all_frames", "candidates"])
def test_select_views_for_chunk_matches_jax(scenes, candidates):
    jscene, scene = scenes
    pts = scene.points[::7]
    args = (scene.depth, scene.poses, scene.intrinsics, 4)
    for rng in (None, 11):
        want = jview_select.select_views_for_chunk(
            pts, *args, candidate_frames=candidates, rng=None if rng is None else np.random.default_rng(rng)
        )
        got = view_select.select_views_for_chunk(
            pts, *args, candidate_frames=candidates, rng=None if rng is None else np.random.default_rng(rng)
        )
        np.testing.assert_array_equal(got, want)


def test_grid_index_native_and_numpy_match_jax(rng, monkeypatch):
    pts = rng.uniform(0, 8, (50000, 3)).astype(np.float32)
    boxes = [((4.0, 4.0), 0.95), ((0.2, 7.8), 1.2), ((9.5, 9.5), 0.5), ((20.0, 20.0), 1.0)]
    assert native.available()
    gi, jgi = native.GridIndex(pts, cell=0.6), jnative.GridIndex(pts, cell=0.6)
    assert gi._native
    got = [gi.query_box(center, half) for center, half in boxes]
    monkeypatch.setattr(native, "_load", lambda: None)  # a host without a compiler
    gi_numpy = native.GridIndex(pts, cell=0.6)
    assert not gi_numpy._native
    for (center, half), native_idx in zip(boxes, got):
        np.testing.assert_array_equal(native_idx, jgi.query_box(center, half))
        near = np.abs(pts[:, :2] - np.asarray(center))
        brute = np.nonzero((near[:, 0] <= half) & (near[:, 1] <= half))[0]
        np.testing.assert_array_equal(gi_numpy.query_box(center, half), brute)
        np.testing.assert_array_equal(np.sort(native_idx), brute)


def test_greedy_views_native_and_numpy_match_jax(rng, monkeypatch):
    cov = rng.random((16, 300)) < 0.25
    want, want_cov = jview_select.greedy_select_views(cov, 4)
    got, got_cov = view_select.greedy_select_views(cov, 4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_cov, want_cov)
    monkeypatch.setattr(native, "_load", lambda: None)
    numpy_path, numpy_cov = view_select.greedy_select_views(cov, 4)
    np.testing.assert_array_equal(numpy_path, want)
    np.testing.assert_array_equal(numpy_cov, want_cov)


def test_native_library_builds_into_the_port():
    """The port compiles the repository's native source into its own
    git-ignored build directory, never into native/."""
    assert native.available()
    port = pathlib.Path(native.__file__).resolve().parents[1]
    assert pathlib.Path(native._LIB_PATH) == port / "build" / "libmvpnet_host.so"
    assert pathlib.Path(native._LIB_PATH).exists()
    assert pathlib.Path(native._SOURCE) == port.parent / "native" / "host_index.cpp"


def test_meta_matches_jax():
    assert meta.CLASS_NAMES == jmeta.CLASS_NAMES and meta.NYU40_IDS == jmeta.NYU40_IDS
    np.testing.assert_array_equal(meta.CLASS_COLORS, jmeta.CLASS_COLORS)
    ids = np.array([0, 5, 19, -100, 3])
    np.testing.assert_array_equal(meta.remap_to_nyu40(ids), jmeta.remap_to_nyu40(ids))
    np.testing.assert_array_equal(meta.nyu40_to_train(), jmeta.nyu40_to_train())


_Batch = collections.namedtuple("_Batch", ["points", "labels"])


def _plain_batches(kind: str) -> list:
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(5):
        points = rng.normal(size=(2, 16, 3)).astype(np.float32)
        label = rng.integers(0, 20, (2, 16)).astype(np.int8)
        if kind == "dict":
            batches.append({"points": points, "seg_label": label})
        elif kind == "namedtuple":
            batches.append(_Batch(points, [label]))
        else:
            batches.append((points, [label]))
    return batches


def _host(x):
    """A batch of device arrays (either package) as numpy, in its structure."""
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, _Batch):
        return _Batch(*(_host(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_host(v) for v in x)
    return np.asarray(x)


@pytest.mark.parametrize("kind", ["dict", "tuple", "namedtuple"])
@pytest.mark.parametrize("pack", [False, True], ids=["copies", "packed"])
def test_prefetch_plain_iterator_matches_jax(kind, pack):
    """A source with no worker_iter: one iterator the workers share, every
    batch in its order, then StopIteration; only dict batches are packed,
    and the rest cross in their own structure, as the JAX package's do."""
    want = _plain_batches(kind)
    got_port, got_jax = [], []
    for module, out in ((pipeline, got_port), (jpipeline, got_jax)):
        it = module.PrefetchIterator(iter(_plain_batches(kind)), prefetch=2, num_threads=1, pack=pack)
        try:
            out.extend(_host(b) for b in it)
        finally:
            it.close()
    for batches in (got_port, got_jax):
        assert len(batches) == len(want)
        for got, ref in zip(batches, want):
            assert type(got) is type(ref)
            for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref)):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)


def test_prefetch_moves_tensors_in_a_batch():
    """Tensors inside a batch cross to the device as arrays do, in the
    batch's structure."""
    batch = (torch.ones(2, 3), [np.zeros(4, np.float32)])
    it = pipeline.PrefetchIterator(iter([batch]), num_threads=1, device="meta")
    try:
        (got,) = list(it)
    finally:
        it.close()
    assert isinstance(got, tuple) and isinstance(got[1], list)
    assert got[0].device.type == "meta" and got[1][0].device.type == "meta"
    assert got[0].shape == (2, 3) and got[1][0].shape == (4,)


def test_prefetch_plain_iterator_keeps_order_across_threads():
    """Four workers on one shared stream: every batch once, in order, and the
    end of the stream after the last of them."""
    batches = [{"i": np.full(1, i, np.int64)} for i in range(200)]
    it = pipeline.PrefetchIterator(iter(batches), prefetch=4, num_threads=4)
    try:
        got = [int(b["i"][0]) for b in it]
    finally:
        it.close()
    assert got == list(range(200))
    assert all(not t.is_alive() for t in it._threads)
