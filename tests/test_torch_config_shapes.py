"""Config #3's training at its structure (``mvpnet_torch/config_shapes.py``)
against the JAX package, on the CPU.

Both packages read ``configs/scannet/mvpnet_3d_32k_chunks.yaml`` to equal
values. At narrow widths and N cut to 4096 (SA npoints scaled by 1/8 so every
level keeps its radius and nsample 32; B=8 as 4 microbatches of 2 by
``grad_accum``), the same numpy batch (8 chunks of 3 m from a synthetic
scene) and the weights carried by
``convert.load_jax_params`` go through JAX's ``make_train_step`` and the port's,
with ``train.remat`` off and on: the loss to tests/test_parity.py's 5e-3
absolute, every gradient (the mean over the microbatches) to cosine > 0.999,
and every conv and linear kernel's (the leaves test_parity.py gates) with its
norm within 1%. (The BatchNorm scales' and biases' gradients are sums that
nearly cancel: at 8 x 4096 points their norms part by up to 1.4% while their
cosines stay above 0.999.) Then the module's own contract: the launches it
asserts and the fusion kNN's mode at each config's full shape, a tiny CPU run
that writes every key, and the raise without CUDA.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch
from flax import nnx

from mvpnet_tpu.config import load_config as jax_load_config
from mvpnet_tpu.data.pipeline import ChunkDataset as JaxChunkDataset
from mvpnet_tpu.data.synthetic import make_scene as jax_make_scene
from mvpnet_tpu.models import build_model as jax_build_model
from mvpnet_tpu.ops import reference as jax_reference
from mvpnet_tpu.train.solver import build_optimizer as jax_build_optimizer
from mvpnet_tpu.train.step import make_train_step as jax_make_train_step
from mvpnet_tpu.train.step import prepare_batch as jax_prepare_batch
from mvpnet_torch import config_shapes, convert, ops
from mvpnet_torch.config import load_config, to_dict
from mvpnet_torch.entry import TRAIN_CONFIG
from mvpnet_torch.models import build_model
from mvpnet_torch.train import solver
from mvpnet_torch.train.step import make_train_step
from tests.test_torch_models import _flat_params, _port_cfg, jax_keys

# the H100's block shared memory for the FPS rows (route's boundary: 14,432 points)
H100_SHARED = 14432 * 16
SMOKE_CONFIG = os.path.join(os.path.dirname(TRAIN_CONFIG), "mvpnet_3d_synthetic_smoke.yaml")
N_CUT = 4096
# config #3's structure at narrow widths: its SA radii and nsample, npoints
# 4096 / 1024 / 256 / 64 scaled by N_CUT / 32768
NARROW = [
    "data.name=synthetic", f"data.num_points={N_CUT}", "data.image_height=24", "data.image_width=32",
    "data.num_classes=5", "data.augment=false", "train.batch_size=8",
    "model.unet.num_classes=5", "model.unet.base_channels=8", "model.unet.stage_channels=[8,16,16,32]",
    "model.unet.stage_blocks=[1,1,1,1]", "model.unet.decoder_channels=[16,16,8,8]", "model.unet.feature_channels=8",
    "model.unet.dtype=float32", "model.aggregation.mlp_channels=[8,8]", "model.pn2.num_classes=5",
    "model.pn2.in_channels=8", "model.pn2.dtype=float32", "model.pn2.head_channels=16", "model.pn2.dropout=0.0",
    "model.pn2.sa=[{npoint: 512, radius: 0.1, nsample: 32, mlp_channels: [8,8,16]}, "
    "{npoint: 128, radius: 0.2, nsample: 32, mlp_channels: [16,16,32]}, "
    "{npoint: 32, radius: 0.4, nsample: 32, mlp_channels: [32,32,32]}, "
    "{npoint: 8, radius: 0.8, nsample: 32, mlp_channels: [32,32,64]}]",
    "model.pn2.fp_channels=[[32,32],[32,16],[16,16],[16,16,16]]",
]
TINY = [
    "data.num_points=256", "data.image_height=24", "data.image_width=32", "data.max_candidate_frames=8",
    "data.num_workers=1", "data.synthetic_scenes=2", "data.num_classes=5", "train.batch_size=4",
    "model.unet.num_classes=5", "model.unet.base_channels=8", "model.unet.stage_channels=[8,16,16,32]",
    "model.unet.stage_blocks=[1,1,1,1]", "model.unet.decoder_channels=[16,16,8,8]", "model.unet.feature_channels=8",
    "model.unet.dtype=float32", "model.aggregation.mlp_channels=[8,8]", "model.pn2.num_classes=5",
    "model.pn2.in_channels=8", "model.pn2.dtype=float32", "model.pn2.head_channels=16", "model.pn2.dropout=0.0",
    "model.pn2.sa=[{npoint: 32, radius: 0.2, nsample: 8, mlp_channels: [16,16]}, "
    "{npoint: 8, radius: 0.4, nsample: 8, mlp_channels: [16,32]}]",
    "model.pn2.fp_channels=[[32],[32,16]]",
]


def test_configs_read_the_32k_yaml_alike():
    port = load_config(config_shapes.CONFIG3)
    want = to_dict(jax_load_config(config_shapes.CONFIG3))
    assert jax_keys(to_dict(port)) == want
    assert (port.train.batch_size, port.train.grad_accum, port.data.num_points) == (32, 4, 32768)


@pytest.mark.parametrize("path,rows,launches,mode", [
    (config_shapes.CONFIG3, 8, {"knn_fusion": 4, "fps_perrow": 4, "fps": 12, "ball_query": 16, "knn": 16}, "demand"),
    (config_shapes.CONFIG4, 2, {"knn_fusion": 1, "fps_perrow": 1, "fps": 3, "ball_query": 4, "knn": 4}, "demand"),
    (TRAIN_CONFIG, 8, {"knn_fusion": 1, "fps_perrow": 0, "fps": 4, "ball_query": 4, "knn": 4}, "brute"),
    (SMOKE_CONFIG, 4, {"knn_fusion": 0, "fps_perrow": 0, "fps": 4, "ball_query": 4, "knn": 5}, None),
], ids=["config3", "config4_train", "train_config", "smoke_config"])
def test_launches_and_fusion_mode_at_full_shape(path, rows, launches, mode):
    """A step's launches on the card (a microbatch's times grad_accum) and
    the fusion kNN's mode: config #3 first trains through row 5 and row 1's
    demand mode; the training config stays in the brute mode on the block FPS;
    the smoke config's pixel cloud (3 x 60 x 80) is below the fusion kNN's
    minimum, so the brute kNN takes the search."""
    cfg = load_config(path, config_shapes.SYNTHETIC)
    accum = max(1, cfg.train.grad_accum)
    assert cfg.train.batch_size // accum == rows
    per_step = {k: n * accum for k, n in config_shapes.expected_launches(cfg, H100_SHARED).items()}
    assert per_step == dict(dict.fromkeys(ops.KERNELS, 0), **launches)
    assert config_shapes.fusion_mode(cfg, rows) == mode


def _direct_sqdist(a, b):
    """The port's distance form, (dx*dx + dy*dy) + dz*dz, in place of JAX's
    |a|^2 - 2ab + |b|^2 (``mvpnet_tpu/ops/reference.py:35``; ROADMAP.md
    Queue 3, known deviations): at 8 x 4096 queries the expansion's ~1e-6
    rounding reorders near-tied neighbors of the fusion kNN and the ball
    query, which moves the max-pooled aggregation's gradients by a few
    percent. The fixture's JAX step takes this form, so both packages make
    the same index decisions and the gate holds the step itself."""
    import jax.numpy as jnp

    d = a[..., :, None, :] - b[..., None, :, :]
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


@pytest.fixture(scope="module")
def jax_steps():
    """JAX at config #3's narrow structure, remat off and on: the initial
    weights, the mean gradient over the 4 microbatches and make_train_step's
    loss on one numpy batch: 8 chunks of 3 m from a synthetic scene (JAX's
    ChunkDataset; surface points at the density a 32k-point chunk has, so
    SA1's 0.1 m balls hold neighbors), on continuous coordinates."""
    jcfg = jax_load_config(config_shapes.CONFIG3, NARROW)
    scene = jax_make_scene(7, num_points=60000, num_frames=6, height=24, width=32, num_classes=5)
    raw = next(iter(JaxChunkDataset([scene], jcfg.data, batch_size=8, training=True, seed=3)))
    # the wire format's millimetre points, made continuous by a sub-millimetre
    # jitter: on a millimetre grid exact distance ties are common, and the two
    # packages' distance forms (JAX's |a|^2 - 2ab + |b|^2) break them apart
    jitter = np.random.default_rng(1).uniform(-5e-4, 5e-4, raw["points"].shape)
    raw["points"] = (raw["points"] / 1000.0 + jitter).astype(np.float32)
    out = {}
    patch = pytest.MonkeyPatch()
    patch.setattr(jax_reference, "pairwise_sqdist", _direct_sqdist)
    for remat in (False, True):
        jcfg = jax_load_config(config_shapes.CONFIG3, NARROW + [f"train.remat={str(remat).lower()}"])
        assert jcfg.train.grad_accum == 4 and jcfg.train.remat == remat
        model, loss_fn, metric_fn = jax_build_model(jcfg, rngs=nnx.Rngs(0))
        init = _flat_params(model)

        @nnx.jit  # the batch is an argument: as a closed-over constant XLA folds the kNN sort for minutes
        def value_and_grad(m, mb):
            return nnx.value_and_grad(lambda m: loss_fn(m(mb), mb))(m)

        grads = None
        for a in range(4):
            mb = jax_prepare_batch(jcfg, jax.device_put({k: v[2 * a : 2 * a + 2] for k, v in raw.items()}),
                                   training=True)
            _, g = value_and_grad(nnx.clone(model), mb)
            g = {"/".join(map(str, k)): np.asarray(v[...], np.float64) for k, v in nnx.to_flat_state(g)}
            grads = g if grads is None else {k: grads[k] + g[k] for k in g}
        optimizer = nnx.Optimizer(model, jax_build_optimizer(jcfg.solver), wrt=nnx.Param)
        m = jax_make_train_step(jcfg, loss_fn, metric_fn)(model, optimizer, jax.device_put(raw), jax.random.key(0))
        out[remat] = dict(cfg=jcfg, init=init, grads={k: v / 4 for k, v in grads.items()}, loss=float(m["loss"]))
    patch.undo()
    return raw, out


@pytest.mark.parametrize("remat", [False, True], ids=["base", "remat"])
def test_train_step_matches_jax_at_config3_structure(jax_steps, remat):
    raw, runs = jax_steps
    run = runs[remat]
    cfg = _port_cfg(run["cfg"])
    assert (cfg.train.grad_accum, cfg.train.remat) == (4, remat)
    model, loss_fn, metric_fn = build_model(cfg)
    convert.load_jax_params(model, run["init"])
    assert model.remat_2d == remat
    model.train()
    optimizer = solver.build_optimizer(cfg.solver, model.parameters())
    m = make_train_step(cfg, loss_fn, metric_fn)(model, optimizer, {k: torch.from_numpy(v) for k, v in raw.items()})
    assert abs(float(m["loss"]) - run["loss"]) < 5e-3, (float(m["loss"]), run["loss"])
    named = dict(model.named_parameters())
    assert len(run["grads"]) == len(named)
    for key, jg in run["grads"].items():
        tkey, jg = convert._torch_key(key, jg)
        g = named[tkey].grad.double().numpy()  # the step's accumulated gradient, divided by grad_accum
        gn, jn = np.linalg.norm(g), np.linalg.norm(jg)
        cos = float(np.dot(g.ravel(), jg.ravel()) / (gn * jn + 1e-30))
        assert cos > 0.999, f"{key}: grad cosine {cos}"
        if key.endswith("kernel"):  # the leaves tests/test_parity.py gates by norm
            assert 0.99 < gn / (jn + 1e-30) < 1.01, f"{key}: grad norm ratio {gn / (jn + 1e-30)}"


def test_main_on_the_cpu_writes_every_key(monkeypatch, tmp_path):
    for name, value in (("STEPS", 1), ("ENTRY_STEPS", 1), ("SCENE_POINTS", 3000), ("SCENE_FRAMES", 4)):
        monkeypatch.setattr(config_shapes, name, value)
    out = config_shapes.main(["--device", "cpu", "--out-dir", str(tmp_path), "--name", "cpu", *TINY])
    with open(tmp_path / "cpu.json") as f:
        assert json.load(f) == json.loads(json.dumps(out))
    assert set(out) == {"card", "torch", "overrides", "config3", "config4_train", "config4"}
    assert out["card"] == "cpu"
    variant_keys = {"step_ms", "step_ms_all", "chunks_per_sec", "first_step_s", "loss", "losses", "hbm",
                    "launches_per_step"}
    for name in ("config3", "config4_train"):
        res = out[name]
        assert {"shape", "grad_accum", "pixel_refs", "fusion_mode", "base", "remat", "donate"} <= set(res)
        assert res["donate"]["applicable"] is False
        for variant in ("base", "remat"):
            assert set(res[variant]) == variant_keys
            assert np.isfinite(res[variant]["loss"]) and res[variant]["step_ms"] > 0
            assert set(res[variant]["launches_per_step"].values()) == {0}  # the plain versions on the CPU
    assert out["config3"]["grad_accum"] == 4 and out["config3"]["shape"]["V"] == 3
    assert out["config4_train"]["shape"]["V"] == 8
    assert {"steps", "step_ms", "data_wait_ms", "chunks_per_sec", "loss"} <= set(out["config3"]["train_entry"])
    scene = out["config4"]
    assert set(scene) == {"scene", "scene_eval_s", "scene_eval_warm_s", "pixel_stage_ms", "knn_prepare_ms",
                          "fuse_per_chunk_ms", "hbm", "logits_shape", "launches_per_scene"}
    assert scene["logits_shape"] == [3000, 5] and scene["scene"]["views"] == 4 and scene["scene"]["n_chunks"] >= 1


def test_main_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        config_shapes.main(["--out-dir", str(tmp_path), *TINY])
    assert not list(tmp_path.iterdir())
