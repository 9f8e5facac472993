"""The port's frame path of 2D pretraining (core.augment's frame
augmentation, train.step.prepare_frame_batch, the colors branch of
prepare_batch, data.frames.FrameDataset, build_dataset's frame sampling and
frame batches through PrefetchIterator) against the JAX package, on the CPU.

FrameDataset is a NumPy copy: the same scenes and seed give the same
batches byte for byte. The augmentation draws differ between the packages
(torch.Generator against jax.random), so JAX's draws are read out of its
key and handed to the port's apply function; both apply them in float32,
to 1e-5. Dequantization is one IEEE division on both sides: exact.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvpnet_tpu.core.augment import augment_frame
from mvpnet_tpu.data import frames as jframes
from mvpnet_tpu.data import pipeline as jpipeline
from mvpnet_tpu.data import synthetic as jsynthetic
from mvpnet_tpu.train.step import prepare_batch as jax_prepare_batch
from mvpnet_torch import config as port_config
from mvpnet_torch.core.augment import apply_frame_augment, sample_frame_params
from mvpnet_torch.data import frames, pipeline, synthetic
from mvpnet_torch.train.step import prepare_batch, prepare_frame_batch
from tests.test_pipeline import small_data_cfg
from tests.test_torch_models import _port_cfg
from tests.test_models import tiny_config

SCENE = dict(num_points=4000, height=24, width=32, num_classes=5)
FRAMES = (5, 3, 7)  # frames of each scene


@pytest.fixture(scope="module")
def scenes():
    """Each package's own synthetic scenes from the same seeds."""
    jax_scenes = [jsynthetic.make_scene(i, num_frames=f, **SCENE) for i, f in enumerate(FRAMES)]
    port_scenes = [synthetic.make_scene(i, num_frames=f, **SCENE) for i, f in enumerate(FRAMES)]
    return jax_scenes, port_scenes


def _port_data_cfg(jcfg):
    return port_config._merge_dataclass(port_config.DataConfig(), port_config.to_dict(jcfg))


def _datasets(scenes, batch_size=4, training=True, seed=5, **kw):
    jcfg = small_data_cfg(sampling="frames", **kw)
    jax_scenes, port_scenes = scenes
    return (
        jframes.FrameDataset(jax_scenes, jcfg, batch_size=batch_size, training=training, seed=seed),
        frames.FrameDataset(port_scenes, _port_data_cfg(jcfg), batch_size=batch_size, training=training, seed=seed),
    )


def _assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    for key in want:
        if isinstance(want[key], np.ndarray):
            assert got[key].dtype == want[key].dtype, key
            assert got[key].tobytes() == want[key].tobytes(), key
        else:
            assert got[key] == want[key], key


# ---------------------------------------------------------------------------
# Frame augmentation and batch preparation
# ---------------------------------------------------------------------------


def _jax_frame_params(key, flip_prob, jitter):
    """The draws augment_frame makes from ``key``, in its order."""
    kf, kj = jax.random.split(key)
    kb, kc = jax.random.split(kj)
    return {
        "flip": bool(jax.random.bernoulli(kf, flip_prob)),
        "brightness": float(jax.random.uniform(kb, (), minval=1.0 - jitter, maxval=1.0 + jitter)),
        "contrast": float(jax.random.uniform(kc, (), minval=1.0 - jitter, maxval=1.0 + jitter)),
    }


@pytest.mark.parametrize("flip_prob,jitter", [(0.5, 0.4), (0.9, 0.0), (0.0, 0.2), (1.0, 0.4)])
def test_frame_augment_application_matches_jax(rng, flip_prob, jitter):
    """The same parameters through apply_frame_augment and JAX's
    augment_frame (whose own key draws are read out and injected)."""
    B = 6
    images = rng.uniform(size=(B, 7, 9, 3)).astype(np.float32)
    labels = rng.integers(-1, 5, (B, 7, 9)).astype(np.int32)
    keys = jax.random.split(jax.random.key(3), B)
    per = [_jax_frame_params(k, flip_prob, jitter) for k in keys]
    params = {name: torch.tensor([p[name] for p in per]) for name in per[0]}
    want = jax.vmap(lambda k, im, lb: augment_frame(k, im, lb, flip_prob=flip_prob, jitter=jitter))(
        keys, jnp.asarray(images), jnp.asarray(labels)
    )
    got = apply_frame_augment(torch.from_numpy(images), torch.from_numpy(labels), params,
                              flip_prob=flip_prob, jitter=jitter)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    if flip_prob == 1.0:  # every frame mirrored: label columns reversed
        np.testing.assert_array_equal(got[1].numpy(), labels[:, :, ::-1])


def test_sample_frame_params_draws_from_the_generator():
    a = sample_frame_params(torch.Generator().manual_seed(1), 4096, flip_prob=0.25, jitter=0.4)
    b = sample_frame_params(torch.Generator().manual_seed(1), 4096, flip_prob=0.25, jitter=0.4)
    for k in a:
        assert a[k].shape == (4096,) and torch.equal(a[k], b[k])
    assert 0.2 < a["flip"].float().mean() < 0.3
    for k in ("brightness", "contrast"):
        assert 0.6 <= a[k].min() and a[k].max() < 1.4


@pytest.mark.parametrize("compact", [True, False], ids=["compact", "float32"])
def test_prepare_frame_batch_matches_jax(scenes, compact):
    """Dequantization and the views axis, with no depth mask, exactly; the
    training draw applies sample_frame_params of the same generator."""
    jds, _ = _datasets(scenes, compact_transfer=compact)
    raw = next(iter(jds))
    assert "depth" not in raw
    jcfg = dataclasses.replace(tiny_config(), data=small_data_cfg(sampling="frames", compact_transfer=compact))
    cfg = _port_cfg(jcfg)
    want = jax_prepare_batch(jcfg, jax.device_put(raw), training=False)
    batch = {k: torch.from_numpy(v) for k, v in raw.items()}
    got = prepare_batch(cfg, batch, training=False)
    assert set(got) == set(want) == {"images", "seg_label_2d"}
    for k in got:
        assert got[k].numpy().dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert got["images"].shape == (4, 1, 24, 32, 3)
    assert (got["seg_label_2d"] == cfg.data.ignore_label).any()  # ignored pixels stay as they are

    trained = prepare_frame_batch(cfg, batch, training=True, generator=torch.Generator().manual_seed(7))
    d = cfg.data
    params = sample_frame_params(torch.Generator().manual_seed(7), 4, flip_prob=d.flip_prob, jitter=d.color_jitter)
    images, labels = apply_frame_augment(got["images"][:, 0], got["seg_label_2d"][:, 0], params,
                                         flip_prob=d.flip_prob, jitter=d.color_jitter)
    assert torch.equal(trained["images"][:, 0], images) and torch.equal(trained["seg_label_2d"][:, 0], labels)
    assert not torch.equal(trained["images"], got["images"])


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_prepare_batch_forwards_colors_as_jax(scenes, dtype):
    jcfg = dataclasses.replace(tiny_config(), data=small_data_cfg(include_colors=True))
    jscene = scenes[0][0]
    raw = next(iter(jpipeline.ChunkDataset([jscene], jcfg.data, batch_size=2, training=False, seed=1)))
    if dtype == "uint8":
        raw["colors"] = np.round(raw["colors"] * 255).astype(np.uint8)
    want = jax_prepare_batch(jcfg, jax.device_put(raw), training=False)
    got = prepare_batch(_port_cfg(jcfg), {k: torch.from_numpy(v) for k, v in raw.items()}, training=False)
    assert set(got) == set(want) and "colors" in got
    assert got["colors"].dtype == torch.float32
    np.testing.assert_array_equal(got["colors"].numpy(), np.asarray(want["colors"]))


# ---------------------------------------------------------------------------
# FrameDataset, byte for byte
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compact", [True, False], ids=["compact", "float32"])
def test_frame_sample_matches_jax(scenes, compact):
    jds, ds = _datasets(scenes, compact_transfer=compact)
    assert jds.index == ds.index and len(ds.index) == sum(FRAMES)
    for _ in range(6):
        _assert_same(ds.sample(), jds.sample())
    s = ds.sample(np.random.default_rng(9))
    _assert_same(s, jds.sample(np.random.default_rng(9)))
    assert s["images"].dtype == (np.uint8 if compact else np.float32)
    assert s["seg_label_2d"].dtype == (np.int8 if compact else np.int32)


@pytest.mark.parametrize("per_visit", [1, 8])
def test_frame_visit_stream_matches_jax(scenes, per_visit):
    """The scene-visit stream with its shuffle buffer (per_visit 8) and the
    uniform stream (per_visit 1)."""
    jds, ds = _datasets(scenes, frames_per_scene_visit=per_visit)
    for got, want in itertools.islice(zip(ds, jds), 5):
        _assert_same(got, want)
        assert got["images"].shape == (4, 24, 32, 3)


def test_frame_worker_iter_matches_jax(scenes):
    jds, ds = _datasets(scenes)
    for worker in (0, 3):
        for got, want in itertools.islice(zip(ds.worker_iter(worker), jds.worker_iter(worker)), 3):
            _assert_same(got, want)
    a, b = next(ds.worker_iter(0)), next(ds.worker_iter(1))
    assert a["images"].tobytes() != b["images"].tobytes()  # workers draw their own streams


def test_frame_iter_epoch_matches_jax(scenes):
    """Every frame once, in order; the last batch padded with its final
    frame, n_real marking the real rows."""
    jds, ds = _datasets(scenes, training=False)
    got, want = list(ds.iter_epoch()), list(jds.iter_epoch())
    assert len(got) == len(want) == 4  # 15 frames, batches of 4
    for g, w in zip(got, want):
        _assert_same(g, w)
    assert [b["n_real"] for b in got] == [4, 4, 4, 3]
    last = got[-1]["images"]
    assert last[3].tobytes() == last[2].tobytes()


def test_frame_dataset_rejects_empty():
    cfg = _port_data_cfg(small_data_cfg(sampling="frames"))
    with pytest.raises(ValueError):
        frames.FrameDataset([], cfg, batch_size=2)


def test_build_dataset_frames_matches_jax():
    jcfg = small_data_cfg(sampling="frames", synthetic_scenes=2)
    cfg = _port_data_cfg(jcfg)
    for training in (True, False):
        want = jpipeline.build_dataset(jcfg, batch_size=3, training=training, seed=2)
        got = pipeline.build_dataset(cfg, batch_size=3, training=training, seed=2)
        assert isinstance(got, frames.FrameDataset) and got.index == want.index
        _assert_same(next(got.worker_iter(0)), next(want.worker_iter(0)))
    with pytest.raises(ValueError, match="sampling"):
        pipeline.build_dataset(dataclasses.replace(cfg, sampling="pixels"), batch_size=1, training=True)


# ---------------------------------------------------------------------------
# Frame batches through the prefetcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pack", [False, True], ids=["plain", "packed"])
def test_prefetch_frame_batches(scenes, pack):
    """Per-worker frame streams and the epoch pass (with its n_real) cross
    as they are, compact dtypes kept."""
    _, ds = _datasets(scenes)
    it = pipeline.PrefetchIterator(ds, prefetch=1, num_threads=1, pack=pack)
    try:
        got = next(it)
    finally:
        it.close()
    want = next(ds.worker_iter(0))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.from_numpy(want[k]).dtype and torch.equal(got[k], torch.from_numpy(want[k])), k
    assert got["images"].dtype == torch.uint8 and got["seg_label_2d"].dtype == torch.int8

    _, ds = _datasets(scenes, training=False)
    it = pipeline.PrefetchIterator(ds.iter_epoch(), prefetch=1, num_threads=2, pack=pack)
    try:
        epoch = list(it)
    finally:
        it.close()
    want = list(ds.iter_epoch())
    assert [b["n_real"] for b in epoch] == [b["n_real"] for b in want]
    for g, w in zip(epoch, want):
        assert torch.equal(g["images"], torch.from_numpy(w["images"]))
