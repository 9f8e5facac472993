"""A copy of the benchmark with tiny cells added by dropping in files, for
CPU tests: a narrow configuration, a small traffic mix for each driver, a
cell of each, and the new cells' entries in the copy's BENCHMARK.json."""
from __future__ import annotations

import copy
import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TRAIN, SCENE = "tiny.train", "tiny.scene"


def tiny_config() -> dict:
    with open(os.path.join(REPO, "portbench", "configs", "mvpnet3d_32k.json")) as fh:
        cfg = json.load(fh)["config"]
    cfg = copy.deepcopy(cfg)
    unet = cfg["model"]["unet"]
    unet.update(base_channels=8, stage_channels=[8, 8, 16, 16], stage_blocks=[1, 1, 1, 1],
                decoder_channels=[16, 8, 8, 8], feature_channels=8)
    cfg["model"]["aggregation"]["mlp_channels"] = [8, 8, 8]
    pn2 = cfg["model"]["pn2"]
    pn2.update(in_channels=8, head_channels=8, fp_channels=[[16, 16], [16, 8], [8, 8], [8, 8, 8]])
    pn2["sa"] = [
        {"npoint": 64, "radius": 0.2, "nsample": 8, "mlp_channels": [8, 8, 16]},
        {"npoint": 32, "radius": 0.4, "nsample": 8, "mlp_channels": [16, 16, 16]},
        {"npoint": 16, "radius": 0.8, "nsample": 8, "mlp_channels": [16, 16, 16]},
        {"npoint": 8, "radius": 1.6, "nsample": 8, "mlp_channels": [16, 16, 16]},
    ]
    data = cfg["data"]
    data.update(num_points=256, image_height=24, image_width=32, num_views_train=2, num_views_eval=3,
                chunk_size=2.0, chunk_stride=2.0, max_candidate_frames=4, num_workers=2, prefetch=2)
    cfg["train"].update(batch_size=4, grad_accum=2)
    cfg["eval"]["batch_size"] = 2
    # float32: a sound run then agrees with the reference to round-off, so
    # the limits below tell sound runs from broken ones
    cfg["model"]["unet"]["dtype"] = cfg["model"]["pn2"]["dtype"] = "float32"
    return cfg


def make_root(tmp: str, *, extra_metric: bool = True) -> str:
    """The copy under ``tmp``; returns its root."""
    root = os.path.join(tmp, "bench")
    shutil.copytree(os.path.join(REPO, "portbench"), os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    pb = os.path.join(root, "portbench")
    _dump(os.path.join(pb, "configs", "tiny.json"),
          {"source": "test", "reduced": [], "config": tiny_config()})
    room = {"scenes": 2, "points": 3000, "frames": 6, "objects": 3, "room": 3.0}
    _dump(os.path.join(pb, "traffic", "tiny_train.json"), {"driver": "train", **room})
    _dump(os.path.join(pb, "traffic", "tiny_scene.json"), {"driver": "scene", **room, "check_units": 2})
    limits_train = {"logit2d_err": 1e-3, "bias_grad_err": 1e-3, "loss_gap": 1e-4, "grad_gap": 1e-3,
                    "update_gap": 0.02, "batch_rederived": 0.0}
    limits_scene = {"logit_gap": 1e-3, "label_gap": 1e-3}
    for cell, traffic, limits in ((TRAIN, "tiny_train", limits_train), (SCENE, "tiny_scene", limits_scene)):
        _dump(os.path.join(pb, "workloads", f"{cell}.json"),
              {"config": "tiny", "traffic": traffic, "chips": 1, "why": "test", "limits": limits})
        bench["workloads"].append({"name": cell, "config": "tiny", "traffic": traffic, "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            tiny = TRAIN if any(w.endswith(".train") for w in m["workloads"]) else SCENE
            m["workloads"].append(tiny)
    if extra_metric:
        with open(os.path.join(pb, "metrics", "units.tiny.py"), "w") as fh:
            fh.write('"""Units in the window."""\nLAYER = "host data"\nUNIT = "units"\nMOVES = "setup_s"\n'
                     'SOURCE = "host_clock"\n\n\ndef read(run):\n    return float(len(run.units))\n')
        bench["per_layer"].append({"name": "units.tiny", "unit": "units", "better": "higher", "source": "host_clock",
                                   "layer": "host data", "moves": "setup_s", "workloads": [TRAIN, SCENE]})
    _dump(os.path.join(root, "BENCHMARK.json"), bench)
    return root


def _dump(path: str, obj) -> None:
    with open(path, "w") as fh:
        json.dump(obj, fh, indent=1)
