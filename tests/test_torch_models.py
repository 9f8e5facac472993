"""The port's networks against the JAX package's at tests/test_models.py's
tiny_config, float32, with the same weights carried across by
mvpnet_torch.convert.load_jax_params.

The JAX model first runs one train-mode forward so every BN has nontrivial
running statistics (as tests/test_parity.py:45-50 does), then both run in
eval mode on the same numpy batch. Tolerances are test_parity.py's: both
sides are float32 on the CPU with different conv/matmul libraries, so logits
agree to < 5e-3 absolute and > 0.99999 cosine, and argmaxes agree except at
near ties (> 0.999).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import nnx

from mvpnet_tpu.config import to_dict
from mvpnet_tpu.data.pipeline import ChunkDataset
from mvpnet_tpu.data.synthetic import make_scene
from mvpnet_tpu.models import build_model as jax_build_model
from mvpnet_tpu.train import metrics as jax_metrics
from mvpnet_tpu.train.step import prepare_batch as jax_prepare_batch
from mvpnet_torch import config as port_config
from mvpnet_torch import convert
from mvpnet_torch.entry import entry
from mvpnet_torch.models import build_model
from mvpnet_torch.models.blocks import BatchNorm
from mvpnet_torch.train import metrics
from mvpnet_torch.train.step import prepare_batch
from tests.test_models import tiny_config
from tests.test_pipeline import small_data_cfg


def _port_cfg(jax_cfg):
    """The same configuration as a port Config (both packages share the
    dataclass layout, so the JAX config's dict rebuilds it)."""
    return port_config._merge_dataclass(port_config.Config(), to_dict(jax_cfg))


def jax_keys(port_dict: dict) -> dict:
    """A port config's dict without the port's own key
    (``train.deterministic``), which must hold its default, off."""
    out = dict(port_dict, train=dict(port_dict["train"]))
    assert out["train"].pop("deterministic") is False
    return out


def _flat_params(model):
    flat = nnx.to_flat_state(nnx.state(model, nnx.Any(nnx.Param, nnx.BatchStat)))
    return {"/".join(map(str, k)): np.asarray(v[...]) for k, v in flat}


def _agree(a, b, argmax=True):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    scale = max(np.abs(b).max(), 1.0)
    assert np.abs(a - b).max() < 5e-3 * scale, f"max abs {np.abs(a - b).max():.2e} (scale {scale:.2f})"
    cos = np.dot(a.ravel(), b.ravel()) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12)
    assert cos > 0.99999, cos
    if argmax:
        assert (a.argmax(-1) == b.argmax(-1)).mean() > 0.999


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(tiny_config(), data=small_data_cfg())
    # built under nnx.jit: the same weights as the eager build, in half the time
    jmodel = nnx.jit(lambda: jax_build_model(jcfg, rngs=nnx.Rngs(0))[0])()
    scene = make_scene(7, num_points=20000, num_frames=6, height=24, width=32, num_classes=5)
    raw = next(iter(ChunkDataset([scene], jcfg.data, batch_size=2, training=False, seed=3)))
    jbatch = jax_prepare_batch(jcfg, jax.device_put(raw), training=False)
    jmodel.train()  # one train-mode forward: nontrivial BN running stats
    jmodel(jbatch)
    jmodel.eval()

    cfg = _port_cfg(jcfg)
    model, loss_fn, metric_fn = build_model(cfg)
    model.eval()
    convert.load_jax_params(model, _flat_params(jmodel))
    batch = prepare_batch(cfg, {k: torch.from_numpy(v) for k, v in raw.items()}, training=False)
    return jcfg, jmodel, jbatch, cfg, model, batch


def test_config_copy_matches_jax():
    jcfg = dataclasses.replace(tiny_config(), data=small_data_cfg())
    assert jax_keys(port_config.to_dict(_port_cfg(jcfg))) == to_dict(jcfg)
    assert jax_keys(port_config.to_dict(port_config.Config())) == to_dict(type(jcfg)())


def test_prepared_batch_matches_jax(pair):
    _, _, jbatch, _, _, batch = pair
    assert set(batch) == set(jbatch)
    for key in batch:
        np.testing.assert_allclose(batch[key].numpy(), np.asarray(jbatch[key]), rtol=1e-6, atol=1e-5, err_msg=key)


@torch.no_grad()
def test_unet_matches_jax(pair):
    _, jmodel, jbatch, _, model, batch = pair
    B, V, H, W, _ = batch["images"].shape
    jfeat, jlogits = jmodel.net_2d(jbatch["images"].reshape(B * V, H, W, 3))
    feat, logits = model.net_2d(batch["images"].reshape(B * V, H, W, 3))
    assert logits.dtype == torch.float32
    _agree(feat.numpy(), jfeat, argmax=False)
    _agree(logits.numpy(), jlogits)


@torch.no_grad()
def test_pn2ssg_matches_jax(pair, rng):
    _, jmodel, jbatch, cfg, model, batch = pair
    feats = rng.normal(size=batch["points"].shape[:2] + (cfg.model.pn2.in_channels,)).astype(np.float32)
    want = jmodel.net_3d(jbatch["points"], jnp.asarray(feats))
    got = model.net_3d(batch["points"], torch.from_numpy(feats))
    _agree(got.numpy(), want)


@torch.no_grad()
def test_mvpnet3d_matches_jax(pair):
    _, jmodel, jbatch, _, model, batch = pair
    j3d, j2d = jmodel(jbatch)
    t3d, t2d = model(batch)
    assert t3d.dtype == torch.float32 and t3d.shape == j3d.shape
    _agree(t3d.numpy(), j3d)
    _agree(t2d.numpy(), j2d)


@torch.no_grad()
def test_loss_and_metrics_match_jax(pair):
    jcfg, jmodel, jbatch, cfg, model, batch = pair
    out = model(batch)
    j3d = jnp.asarray(out[0].numpy())
    labels = batch["seg_label"].clone()
    labels[0, :10] = cfg.data.ignore_label
    jl = jnp.asarray(labels.numpy())
    ignore = cfg.data.ignore_label
    np.testing.assert_allclose(
        float(metrics.cross_entropy(out[0], labels, ignore)), float(jax_metrics.cross_entropy(j3d, jl, ignore)), rtol=1e-5
    )
    np.testing.assert_allclose(
        float(metrics.seg_accuracy(out[0], labels, ignore)), float(jax_metrics.seg_accuracy(j3d, jl, ignore)), rtol=1e-6
    )
    cm = metrics.confusion_matrix(out[0], labels, cfg.data.num_classes, ignore)
    np.testing.assert_array_equal(cm.numpy(), np.asarray(jax_metrics.confusion_matrix(j3d, jl, cfg.data.num_classes, ignore)))
    iou, miou = metrics.iou_from_confusion(cm)
    jiou, jmiou = jax_metrics.iou_from_confusion(jnp.asarray(cm.numpy()))
    np.testing.assert_allclose(iou.numpy(), np.asarray(jiou), rtol=1e-6)
    np.testing.assert_allclose(float(miou), float(jmiou), rtol=1e-6)


@pytest.mark.parametrize("fault", ["missing", "unconsumed", "shape"])
def test_load_jax_params_rejects_mismatch(pair, fault):
    _, jmodel, _, cfg, _, _ = pair
    flat = _flat_params(jmodel)
    if fault == "missing":
        flat.pop("net_3d/head/bias")
    elif fault == "unconsumed":
        flat["net_3d/extra/kernel"] = np.zeros((2, 2), np.float32)
    else:
        flat["net_3d/head/bias"] = np.zeros(3, np.float32)
    model, _, _ = build_model(cfg)
    with pytest.raises((KeyError, ValueError)):
        convert.load_jax_params(model, flat)


def test_inference_only_surfaces_raise(pair):
    """The 2D and PointNet++ models, once raises, now build with JAX's
    attribute names (tests/test_torch_models_2d.py holds them against JAX);
    an unknown name raises as JAX's does. Train-mode BN, once such a
    surface, runs (tests/test_torch_train.py holds it against flax)."""
    from mvpnet_torch.models.build import PN2Seg, SemSeg2D

    _, _, _, cfg, model, batch = pair
    xyz_only = dataclasses.replace(cfg.model.pn2, in_channels=0)
    for name, kind, attr in (("sem_seg_2d", SemSeg2D, "net_2d"), ("pn2ssg", PN2Seg, "net_3d")):
        mcfg = dataclasses.replace(cfg.model, name=name, pn2=xyz_only)
        built, loss_fn, metric_fn = build_model(dataclasses.replace(cfg, model=mcfg))
        assert isinstance(built, kind) and hasattr(built, attr) and built.training
        assert callable(loss_fn) and callable(metric_fn)
    with pytest.raises(ValueError, match="unknown model"):
        build_model(dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, name="pointnet")))
    bn = BatchNorm(4).train()
    y = bn(torch.arange(8.0).reshape(2, 4))
    assert torch.allclose(y, torch.tensor([[-1.0] * 4, [1.0] * 4]), atol=1e-5)


def test_entry_on_cpu_runs_tiny_config():
    cfg = _port_cfg(dataclasses.replace(tiny_config(), data=small_data_cfg()))
    forward, (model, batch) = entry(device="cpu", cfg=cfg)
    assert batch["points"].shape == (1, cfg.data.num_points, 3)
    assert batch["images"].shape == (1, cfg.data.num_views_eval, 24, 32, 3)
    logits = forward(model, batch)
    assert logits.shape == (1, cfg.data.num_points, cfg.data.num_classes)
    assert torch.isfinite(logits).all()
