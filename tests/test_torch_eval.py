"""The port's whole-scene evaluation (mvpnet_torch.eval) against the JAX
package's, on the CPU, at tests/test_models.py's tiny_config.

Host-side functions (window grid, chunk windows, view sets, NN fill, the
confusion matrix) must agree exactly. The scene estimators run the JAX model
and the port's with the same weights (mvpnet_torch.convert.load_jax_params,
after one train-mode JAX forward gives every BN nontrivial statistics) and
hold the port to test_parity.py::test_whole_scene_eval_parity's tolerances:
both sides are float32 on the CPU with different conv/matmul libraries, so
scene argmaxes agree except at near ties (> 0.995) and accumulated logits
within 5e-3 x scale per window that adds into a point (x the largest count).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from flax import nnx

from mvpnet_tpu.config import EvalConfig as JaxEvalConfig
from mvpnet_tpu.config import load_config as jax_load_config
from mvpnet_tpu.config import to_dict
from mvpnet_tpu.data.pipeline import ChunkDataset
from mvpnet_tpu.data.synthetic import make_scene as jax_make_scene
from mvpnet_tpu.eval import scene_fused as jscene_fused
from mvpnet_tpu.eval import sharded_scene as jsharded
from mvpnet_tpu.eval import whole_scene as jwhole
from mvpnet_tpu.models import build_model as jax_build_model
from mvpnet_tpu.train.step import prepare_batch as jax_prepare_batch
from mvpnet_torch import config as port_config
from mvpnet_torch import convert
from mvpnet_torch import entry as entry_mod
from mvpnet_torch.data.synthetic import make_scene
from mvpnet_torch.eval import scene_fused, sharded_scene, whole_scene
from mvpnet_torch.models import build_model
from tests.test_models import tiny_config
from tests.test_pipeline import small_data_cfg
from tests.test_torch_models import _flat_params, _port_cfg

SCENE = dict(num_points=10000, num_frames=5, height=24, width=32, num_classes=5)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(
        tiny_config(),
        data=small_data_cfg(num_points=128, chunk_size=2.0, chunk_stride=1.5),
        eval=JaxEvalConfig(scene_views=4, batch_size=2),
    )
    jmodel = nnx.jit(lambda: jax_build_model(jcfg, rngs=nnx.Rngs(0))[0])()
    stats_scene = jax_make_scene(7, num_points=20000, num_frames=6, height=24, width=32, num_classes=5)
    raw = next(iter(ChunkDataset([stats_scene], jcfg.data, batch_size=2, training=False, seed=3)))
    jmodel.train()  # one train-mode forward: nontrivial BN running stats
    jmodel(jax_prepare_batch(jcfg, jax.device_put(raw), training=False))
    jmodel.eval()
    cfg = _port_cfg(jcfg)
    model, _, _ = build_model(cfg)
    model.eval()
    convert.load_jax_params(model, _flat_params(jmodel))
    return jcfg, jmodel, cfg, model


@pytest.fixture(scope="module")
def scenes():
    return jax_make_scene(11, **SCENE), make_scene(11, **SCENE)


def _window_counts(scene, cfg):
    counts = np.zeros(len(scene.points), np.int64)
    for sel, _ in sharded_scene.enumerate_scene_chunks(scene, cfg):
        np.add.at(counts, sel, 1)
    return counts


def _agree_scene(got, want, counts):
    assert got.shape == want.shape and got.dtype == np.float32
    assert (got.argmax(1) == want.argmax(1)).mean() > 0.995
    scale = max(np.abs(want).max(), 1.0)
    assert np.abs(got - want).max() < 5e-3 * scale * max(counts.max(), 1)


def test_enumerate_chunk_centers_matches_jax(rng):
    pts = rng.uniform(-3, 5, (2000, 3)).astype(np.float32)
    for size, stride in [(1.5, 0.5), (6.0, 3.0), (2.0, 1.5)]:
        np.testing.assert_array_equal(
            whole_scene.enumerate_chunk_centers(pts, size, stride), jwhole.enumerate_chunk_centers(pts, size, stride)
        )


def test_accum_scene_logits_adds_duplicates(rng):
    P, C = 50, 4
    idx = rng.integers(0, P, (2, 40))
    idx[1, :10] = idx[0, :10]  # the same points in two windows
    idx[0, 20:25] = 3  # and five times in one
    logits = rng.normal(size=(2, 40, C)).astype(np.float32)
    acc, cnt = torch.zeros((P, C)), torch.zeros((P,), dtype=torch.int32)
    for _ in range(2):
        whole_scene.accum_scene_logits(acc, cnt, torch.from_numpy(logits), torch.from_numpy(idx))
    want_acc, want_cnt = np.zeros((P, C), np.float32), np.zeros(P, np.int32)
    for _ in range(2):
        np.add.at(want_acc, idx.reshape(-1), logits.reshape(-1, C))
        np.add.at(want_cnt, idx.reshape(-1), 1)
    np.testing.assert_array_equal(cnt.numpy(), want_cnt)
    # float32 sums of the same terms, possibly in another order
    np.testing.assert_allclose(acc.numpy(), want_acc, rtol=1e-6, atol=1e-6)
    jacc, jcnt = jwhole.accum_scene_logits(
        jax.numpy.zeros((P, C)), jax.numpy.zeros((P,), jax.numpy.int32), logits, idx.astype(np.int32)
    )
    np.testing.assert_array_equal(cnt.numpy() // 2, np.asarray(jcnt))
    np.testing.assert_allclose(acc.numpy() / 2, np.asarray(jacc), rtol=1e-5, atol=1e-6)


def test_evaluator_matches_jax(rng):
    label = rng.integers(0, 5, 3000)
    label[::7] = -100
    pred = rng.integers(0, 5, 3000)
    ev, jev = whole_scene.Evaluator(5), jwhole.Evaluator(5)
    for chunk in np.array_split(np.arange(3000), 3):
        ev.update(pred[chunk], label[chunk])
        jev.update(pred[chunk], label[chunk])
    np.testing.assert_array_equal(ev.cm, jev.cm)
    got, want = ev.results(), jev.results()
    assert set(got["class_iou"]) == set(want["class_iou"])
    # the JAX package takes the IoU in float32 (x64 off), the port in float64
    np.testing.assert_allclose(got["miou"], want["miou"], rtol=1e-6)
    np.testing.assert_allclose(got["accuracy"], want["accuracy"], rtol=1e-12)
    for name, iou in want["class_iou"].items():
        np.testing.assert_allclose(got["class_iou"][name], iou, rtol=1e-6)


def test_nn_fill_uncovered_matches_jax(rng):
    pts = rng.uniform(0, 3, (500, 3)).astype(np.float32)
    acc = rng.normal(size=(500, 4)).astype(np.float32)
    counts = (rng.random(500) > 0.3).astype(np.int32)
    acc[counts == 0] = 0
    got, want = acc.copy(), acc.copy()
    whole_scene.nn_fill_uncovered(pts, got, counts)
    jwhole.nn_fill_uncovered(pts, want, counts)
    np.testing.assert_array_equal(got, want)
    assert np.abs(got[counts == 0]).sum() > 0


def test_scene_views_and_chunks_match_jax(models, scenes):
    jcfg, _, cfg, _ = models
    jscene, scene = scenes
    np.testing.assert_array_equal(sharded_scene.select_scene_views(scene, 4), jsharded.select_scene_views(jscene, 4))
    got, want = sharded_scene.enumerate_scene_chunks(scene, cfg), jsharded.enumerate_scene_chunks(jscene, jcfg)
    assert len(got) == len(want) >= 3
    for (gi, gp), (wi, wp) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gp, wp)


def test_predict_scene_matches_jax(models, scenes):
    jcfg, jmodel, cfg, model = models
    jscene, scene = scenes
    want = jwhole.predict_scene(jmodel, jcfg, jscene, batch_size=2)
    # 9 windows at batch 2: four full groups and a remainder group of 1
    got = whole_scene.predict_scene(model, cfg, scene, batch_size=2)
    _agree_scene(got, want, _window_counts(scene, cfg))


def test_predict_scene_fused_matches_jax(models, scenes):
    """The scene-view-set estimator; the JAX side runs on the CPU through its
    RawRefs path, as the port's prepared cloud does."""
    jcfg, jmodel, cfg, model = models
    jscene, scene = scenes
    want = jscene_fused.predict_scene_fused(jmodel, jcfg, jscene)
    got = scene_fused.predict_scene_fused(model, cfg, scene)
    _agree_scene(got, want, _window_counts(scene, cfg))


def test_evaluate_scenes_results_and_export(models, scenes, tmp_path):
    _, _, cfg, model = models
    _, scene = scenes
    results = whole_scene.evaluate_scenes(model, cfg, [scene], batch_size=2, export_dir=str(tmp_path))
    pred = whole_scene.predict_scene(model, cfg, scene, batch_size=2).argmax(1)
    ev = whole_scene.Evaluator(cfg.data.num_classes, cfg.data.ignore_label)
    ev.update(pred, scene.labels)
    assert results == ev.results()
    exported = np.loadtxt(tmp_path / f"{scene.name}.txt", dtype=np.int64)
    np.testing.assert_array_equal(exported, whole_scene.remap_to_nyu40(pred, cfg.data.ignore_label))
    fused = whole_scene.evaluate_scenes(model, cfg, [scene], fused=True)
    assert 0.0 <= fused["miou"] <= 1.0 and set(fused) == set(results)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1, multi-GPU"):
        whole_scene.evaluate_scenes(model, cfg, [scene], mesh=object())


def test_scene_entry_loads_highres_config():
    evaluate, (model, cfg) = entry_mod.scene_entry(device="cpu")
    want = jax_load_config(entry_mod.HIGHRES_CONFIG)
    assert port_config.to_dict(cfg) == to_dict(want)
    assert cfg.data.num_points == 102400 and cfg.data.num_views_eval == 64
    assert [sa.npoint for sa in cfg.model.pn2.sa] == [8192, 2048, 512, 128]
    assert cfg.data.max_candidate_frames == 128 and cfg.eval.batch_size == 4
    assert (cfg.data.chunk_size, cfg.data.chunk_stride) == (6.0, 3.0)
    assert next(model.parameters()).device == torch.device("cpu")
    assert evaluate.keywords == {"batch_size": 4} and evaluate.args == (model, cfg)


def test_scene_entry_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry_mod.scene_entry()
