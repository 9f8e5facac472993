"""The port's end-to-end recipe run (``mvpnet_torch/e2e_run.py``) on the
CPU: its stage configs against the configs saved by JAX's run of record
(``runs/r5_e2e``), and a tiny run that writes every key of ``results.json``
and keeps configs and metrics, not checkpoints."""
import json
import os

import numpy as np
import pytest

from mvpnet_torch import e2e_run
from mvpnet_torch.config import load_config, to_dict
from mvpnet_torch.data.pipeline import build_dataset
from tests.test_torch_train import TINY

JAX_RUN = "runs/r5_e2e"


@pytest.mark.parametrize("stage", [0, 1])
def test_stage_configs_are_the_jax_runs(stage):
    """The flags of JAX's run of record (1500 + 2500 steps, 16 scenes x 12
    objects, seed 0) build the configs it saved, key for key."""
    got = e2e_run.stage_configs(JAX_RUN, 1500, 2500, 16, 12, 0)[stage]
    name = ("sem_seg_2d", "mvpnet_3d")[stage]
    assert to_dict(got) == to_dict(load_config(f"{JAX_RUN}/{name}/config.yaml"))


def test_e2e_run_writes_every_key(tmp_path):
    out = str(tmp_path / "e2e")
    argv = ["--out", out, "--steps-2d", "2", "--steps-3d", "2", "--eval-scenes", "1", "--seed", "1",
            "--device", "cpu", *TINY, "train.batch_size=2", "data.num_workers=1"]
    results = e2e_run.main(argv)
    with open(os.path.join(out, "results.json")) as f:
        assert json.load(f) == json.loads(json.dumps(results))
    jax_keys = {"val_2d_miou", "val_3d_miou", "whole_scene_single", "steps_2d", "steps_3d", "devices"}
    assert jax_keys | {"whole_scene_sharded", "eval_scenes", "seed", "zero_iou_classes", "absent_classes",
                       "seconds", "launches"} == set(results)
    assert (results["steps_2d"], results["steps_3d"], results["eval_scenes"], results["seed"]) == (2, 2, 1, 1)
    assert results["devices"] == "cpu"
    single, sharded = results["whole_scene_single"], results["whole_scene_sharded"]
    assert set(single) == {"miou", "accuracy", "class_iou"} and len(single["class_iou"]) == 5
    scenes = build_dataset(load_config(os.path.join(out, "mvpnet_3d", "config.yaml")).data, batch_size=1,
                           training=False, seed=123).scenes[:1]
    present = set(np.unique(scenes[0].labels[scenes[0].labels >= 0]))
    names = list(single["class_iou"])
    assert results["absent_classes"] == [n for c, n in enumerate(names) if c not in present]
    assert results["zero_iou_classes"] == sum(single["class_iou"][names[c]] == 0.0 for c in present)
    for miou in (results["val_2d_miou"], results["val_3d_miou"], single["miou"], sharded["miou_sharded"],
                 sharded["miou_fused"]):
        assert 0.0 <= miou <= 1.0
    assert sharded["space"] == 2 and sharded["points"] > 0 and 0.0 <= sharded["agreement"] <= 1.0
    # the bf16 band is at least TAU, so it holds no fewer decisions confident
    assert 0.0 <= sharded["band_share"] <= 1.0 and sharded["median_abs_logit"] >= 0.0
    if sharded["agreement"] == 1.0:
        assert sharded["confident_agreement"] == sharded["band_agreement"] == 1.0
        assert sharded["differ_max_rel_margin"] == 0.0
    assert set(results["seconds"]) == set(results["launches"]) == {"train_2d", "train_3d", "whole_scene",
                                                                    "whole_scene_sharded"}
    for stage, name in (("sem_seg_2d", "sem_seg_2d"), ("mvpnet_3d", "mvpnet_3d")):
        files = set(os.listdir(os.path.join(out, stage)))
        assert {"config.yaml", "metrics.jsonl", "log.txt"} <= files and "checkpoints" not in files
        assert load_config(os.path.join(out, stage, "config.yaml")).model.name == name
    # the 3D stage warm-started from the 2D stage's checkpoint, under the run's seed
    cfg3d = load_config(os.path.join(out, "mvpnet_3d", "config.yaml"))
    assert cfg3d.model.pretrained_2d == f"{out}/sem_seg_2d/checkpoints" and cfg3d.train.seed == 1
    with open(os.path.join(out, "mvpnet_3d", "log.txt")) as f:
        assert "2D warm-start from" in f.read()
