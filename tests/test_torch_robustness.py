"""The port's point-budget robustness sweep (``mvpnet_torch/robustness.py``)
on the CPU, against ``tools/r5_robustness.py`` and the JAX package.

The constants and the configs the sweep restores are the tool's; the stage
configs train 1500 steps a stage in the tool's layout; ``predict_scene`` of
both models agrees with JAX's on the same weights at budgets down to SA1's
npoint (the tiny config's 32, the sweep's 1024 case, where FPS samples
every point) under test_torch_eval's rule; a tiny run writes every key.
"""
import dataclasses
import json
import os
import sys

import jax
import pytest
from flax import nnx

from mvpnet_tpu.config import EvalConfig as JaxEvalConfig
from mvpnet_tpu.config import load_config as jax_load_config
from mvpnet_tpu.config import to_dict
from mvpnet_tpu.data.pipeline import ChunkDataset
from mvpnet_tpu.data.synthetic import make_scene as jax_make_scene
from mvpnet_tpu.eval import whole_scene as jwhole
from mvpnet_tpu.models import build_model as jax_build_model
from mvpnet_tpu.train.step import prepare_batch as jax_prepare_batch
from mvpnet_torch import config as port_config
from mvpnet_torch import convert, e2e_run, robustness
from mvpnet_torch.config import load_config
from mvpnet_torch.eval import whole_scene
from mvpnet_torch.models import build_model
from tests.test_models import tiny_config
from tests.test_pipeline import small_data_cfg
from tests.test_torch_eval import _agree_scene, _window_counts, scenes  # noqa: F401  (fixture)
from tests.test_torch_models import _flat_params, _port_cfg, jax_keys
from tests.test_torch_train import TINY
from tools import r5_robustness as tool

JAX_OUT = "outputs/r5_rob"  # the tool's run layout


def test_constants_are_the_tools():
    assert robustness.BUDGETS == tool.BUDGETS and robustness.N_SCENES == tool.N_SCENES
    assert robustness.COMMON == tool.COMMON


def test_stage_configs_train_the_tools_runs():
    """1500 steps a stage in the tool's layout; the 3D stage warm-started
    from the 2D one; the baseline xyz-only; the 2D stage is e2e_run's; the
    models and data the sweep restores are those the stages trained and
    those the tool loads."""
    runs = robustness.stage_configs(JAX_OUT, seed=3)
    assert list(runs) == ["sem_seg_2d", "mvpnet_3d", "pn2ssg_xyz"]
    for name, cfg in runs.items():
        assert cfg.output_dir == f"{JAX_OUT}/{name}" and cfg.train.max_steps == cfg.train.ckpt_every == 1500
        assert cfg.train.seed == 3 and cfg.data.name == "synthetic" and cfg.data.num_classes == 20
        assert (cfg.data.synthetic_scenes, cfg.data.synthetic_objects) == (16, 12)
    assert to_dict(runs["sem_seg_2d"]) == to_dict(e2e_run.stage_configs(JAX_OUT, 1500, 1500, 16, 12, 3)[0])
    assert runs["mvpnet_3d"].model.pretrained_2d == f"{JAX_OUT}/sem_seg_2d/checkpoints"
    assert runs["pn2ssg_xyz"].model.name == "pn2ssg" and runs["pn2ssg_xyz"].model.pn2.in_channels == 0
    assert runs["mvpnet_3d"].model.name == "mvpnet_3d"
    for name in robustness.CONFIGS:
        swept = robustness.model_config(name, JAX_OUT)
        trained = runs[name]
        assert to_dict(swept.data) == to_dict(trained.data)
        assert to_dict(dataclasses.replace(swept.model, pretrained_2d="")) == to_dict(
            dataclasses.replace(trained.model, pretrained_2d=""))
        want = jax_load_config(f"configs/scannet/{os.path.basename(robustness.CONFIGS[name])}",
                               tool.COMMON + [f"output_dir={JAX_OUT}/{name}"])
        assert jax_keys(port_config.to_dict(swept)) == to_dict(want)
    # the baseline stays xyz-only under overrides that widen the fusion model's
    opts = ["model.pn2.in_channels=8"]
    assert robustness.stage_configs(JAX_OUT, opts=opts)["pn2ssg_xyz"].model.pn2.in_channels == 0
    assert robustness.stage_configs(JAX_OUT, opts=opts)["mvpnet_3d"].model.pn2.in_channels == 8


@pytest.fixture(scope="module")
def pairs():
    """Both models at tiny widths, JAX's and the port's with the same
    weights (one JAX train-mode forward gives every BN nontrivial
    statistics), both in eval mode."""
    base = dataclasses.replace(
        tiny_config(),
        data=small_data_cfg(num_points=128, chunk_size=2.0, chunk_stride=1.5),
        eval=JaxEvalConfig(scene_views=4, batch_size=2),
    )
    stats_scene = jax_make_scene(7, num_points=20000, num_frames=6, height=24, width=32, num_classes=5)
    out = {}
    for name, model_name, in_channels in (("mvpnet_3d", "mvpnet_3d", 8), ("pn2ssg_xyz", "pn2ssg", 0)):
        pn2 = dataclasses.replace(base.model.pn2, in_channels=in_channels)
        jcfg = dataclasses.replace(base, model=dataclasses.replace(base.model, name=model_name, pn2=pn2))
        jmodel = nnx.jit(lambda: jax_build_model(jcfg, rngs=nnx.Rngs(0))[0])()
        raw = next(iter(ChunkDataset([stats_scene], jcfg.data, batch_size=2, training=False, seed=3)))
        jmodel.train()  # under nnx.jit, which carries the BN updates back to the model
        nnx.jit(lambda m, b: m(jax_prepare_batch(jcfg, b, training=False)))(jmodel, jax.device_put(raw))
        jmodel.eval()
        model, _, _ = build_model(_port_cfg(jcfg))
        convert.load_jax_params(model, _flat_params(jmodel))
        out[name] = (jcfg, jmodel, model.eval())
    return out


@pytest.mark.parametrize("budget", [32, 64], ids=["npoint", "between"])
@pytest.mark.parametrize("name", ["mvpnet_3d", "pn2ssg_xyz"])
def test_predict_scene_matches_jax_at_budget(pairs, scenes, name, budget):  # noqa: F811
    """The sweep's forward below the training budget: the tiny config's SA1
    samples 32 centres (npoint = N at budget 32), its balls and FP1 run over
    sparser chunks than the fixture's 128 points."""
    jcfg, jmodel, model = pairs[name]
    assert jcfg.model.pn2.sa[0].npoint == 32 < 64 < jcfg.data.num_points
    jcfg = dataclasses.replace(jcfg, data=dataclasses.replace(jcfg.data, num_points=budget))
    cfg = _port_cfg(jcfg)
    jscene, scene = scenes
    # the scene's 9 windows in 3 forwards of 3: one JAX compile a case
    want = jwhole.predict_scene(jmodel, jcfg, jscene, batch_size=3)
    got = whole_scene.predict_scene(model, cfg, scene, batch_size=3)
    _agree_scene(got, want, _window_counts(scene, cfg))


def test_robustness_run_writes_every_key(tmp_path, monkeypatch):
    # no TensorBoard event files: importing it pulls in tensorflow here
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    out = str(tmp_path / "rob")
    argv = ["--out", out, "--steps-2d", "2", "--steps-3d", "2", "--eval-scenes", "1", "--seed", "1",
            "--device", "cpu", *TINY, "train.batch_size=2", "train.val_steps=1", "data.num_workers=1",
            "data.chunk_size=4.0", "data.chunk_stride=4.0"]
    results = robustness.main(argv)
    with open(os.path.join(out, "results.json")) as f:
        assert json.load(f) == json.loads(json.dumps(results))
    jax_keys_ = {"budgets", "models", "fusion_degrades_more_gracefully"}
    assert jax_keys_ | {"devices", "seed", "eval_scenes", "steps_2d", "steps_3d", "val_2d_miou", "val_3d_miou",
                        "val_pn2ssg_xyz_miou", "seconds", "launches"} == set(results)
    assert results["budgets"] == [8192, 4096, 2048, 1024] and results["devices"] == "cpu"
    assert (results["seed"], results["eval_scenes"], results["steps_2d"], results["steps_3d"]) == (1, 1, 2, 2)
    budgets = [str(b) for b in results["budgets"]]
    assert set(results["models"]) == {"mvpnet_3d", "pn2ssg_xyz"}
    for name, m in results["models"].items():
        assert set(m) == {"restored_step", "miou", "relative_at_min_budget"} and m["restored_step"] == 1
        assert list(m["miou"]) == budgets and all(0.0 <= v <= 1.0 and round(v, 4) == v for v in m["miou"].values())
        assert m["relative_at_min_budget"] == round(m["miou"]["1024"] / max(m["miou"]["8192"], 1e-9), 3)
    # the tool's rule on the written numbers
    rel = {k: v["relative_at_min_budget"] for k, v in results["models"].items()}
    assert results["fusion_degrades_more_gracefully"] == (rel["mvpnet_3d"] > rel["pn2ssg_xyz"])
    for key in ("val_2d_miou", "val_3d_miou", "val_pn2ssg_xyz_miou"):
        assert 0.0 <= results[key] <= 1.0
    for table in (results["seconds"], results["launches"]):
        assert set(table) == {"train_2d", "train_3d", "train_pn2ssg_xyz", "eval"}
        assert {k: list(v) for k, v in table["eval"].items()} == {"mvpnet_3d": budgets, "pn2ssg_xyz": budgets}
    # on the CPU the ops take their plain versions: no launch anywhere
    assert not any(n for stage in ("train_2d", "train_3d", "train_pn2ssg_xyz")
                   for n in results["launches"][stage].values())
    assert not any(n for m in results["launches"]["eval"].values() for c in m.values() for n in c.values())
    for stage, model in (("sem_seg_2d", "sem_seg_2d"), ("mvpnet_3d", "mvpnet_3d"), ("pn2ssg_xyz", "pn2ssg")):
        files = set(os.listdir(os.path.join(out, stage)))
        assert {"config.yaml", "metrics.jsonl", "log.txt"} <= files and "checkpoints" not in files
        cfg = load_config(os.path.join(out, stage, "config.yaml"))
        assert cfg.model.name == model and cfg.train.seed == 1
    assert load_config(os.path.join(out, "pn2ssg_xyz", "config.yaml")).model.pn2.in_channels == 0
    with open(os.path.join(out, "mvpnet_3d", "log.txt")) as f:
        assert f"2D warm-start from {out}/sem_seg_2d/checkpoints: True" in f.read()
