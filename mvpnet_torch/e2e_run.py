"""The recipe end to end on synthetic scenes, trained to a plateau.

Counterpart of ``tools/e2e_run.py`` (same stages, flags and defaults):

  1. frame-level 2D pretraining (``model.name=sem_seg_2d``,
     ``data.sampling=frames``);
  2. ``mvpnet_3d`` fusion training warm-started from that checkpoint
     (``model.pretrained_2d``);
  3. whole-scene evaluation of the trained model on held-out scenes (those
     of ``build_dataset(..., training=False, seed=123)``) through
     ``predict_scene`` (``whole_scene_single``);
  4. the same scenes through the space-sharded estimator on the loopback
     mesh at space 2 (``predict_scene_sharded``) beside the fused one
     (``predict_scene_fused``): their argmax agreement and each one's mIoU
     (``whole_scene_sharded``).

``<out>/results.json`` holds JAX's keys (``val_2d_miou``, ``val_3d_miou``,
``whole_scene_single``, ``steps_2d``, ``steps_3d``, ``devices``: here the
card's name and power limit as nvidia-smi gives them) plus ``eval_scenes``,
``seed``, ``zero_iou_classes`` (classes of the held-out scenes' labels at
zero IoU), ``absent_classes`` (classes with no label there, whose IoU reads
0.0 in ``class_iou`` and which mIoU leaves out), ``whole_scene_sharded``
(``compare_estimators``), ``seconds`` (each stage's wall time) and
``launches`` (each stage's kernel launches). Each stage keeps its
``config.yaml``, ``metrics.jsonl`` and ``log.txt``; the checkpoints are
deleted afterwards.

The synthetic corpus stands in for ScanNet (not in the repository), so the
numbers show the system converging, not ScanNet accuracy. The recipe of
JAX's run of record (``runs/r5_e2e``), at ``train.seed`` 0, is

    python -m mvpnet_torch.e2e_run --out runs/torch_e2e/seed0 --steps-2d 1500 \\
        --steps-3d 2500 --eval-scenes 4 --scenes 16 --objects 12 --seed 0

Trailing ``key=value`` overrides apply to both stages after the recipe's
(the tests' tiny widths); ``--device cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import time

import numpy as np


def card_line(device) -> str:
    """nvidia-smi's name and power limit of the card (``cpu`` on the CPU)."""
    if device.type != "cuda":
        return str(device)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[device.index or 0]


def measured(device, fn) -> tuple:
    """``fn()``'s result, its wall seconds (the card synchronized after it)
    and the kernel launches it made."""
    import torch

    from mvpnet_torch import ops

    before = ops.launch_counts()
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    return out, seconds, {k: n - before[k] for k, n in ops.launch_counts().items()}


def class_counts(scenes, num_classes: int) -> np.ndarray:
    """Labelled points of each class over ``scenes``."""
    labels = np.concatenate([np.asarray(s.labels, np.int64) for s in scenes])
    return np.bincount(labels[(labels >= 0) & (labels < num_classes)], minlength=num_classes)


def compare_estimators(model, cfg, scenes, space: int = 2) -> dict:
    """The sharded estimator on the loopback mesh at ``space`` against the
    fused one on ``scenes``: argmax agreement over every point, on the
    decisions beyond cli.export_3d's tie band TAU (``confident_agreement``)
    and beyond its bf16 band (``band_agreement``, ``bf16_tie_band``), the
    largest relative top-2 margin of the fused logits where the two differ,
    the median |logit|, and each one's mIoU."""
    from mvpnet_torch.cli.export_3d import agreement, bf16_tie_band
    from mvpnet_torch.dist.mesh import make_mesh
    from mvpnet_torch.eval.scene_fused import build_scene_fused_fns, predict_scene_fused
    from mvpnet_torch.eval.sharded_scene import build_sharded_scene_fns, predict_scene_sharded
    from mvpnet_torch.eval.whole_scene import Evaluator

    mesh = make_mesh(local=space)
    sharded_fns, fused_fns = build_sharded_scene_fns(model, cfg, mesh), build_scene_fused_fns(model, cfg)
    evals = {name: Evaluator(cfg.data.num_classes, cfg.data.ignore_label) for name in ("sharded", "fused")}
    got, want = [], []
    for scene in scenes:
        got.append(predict_scene_sharded(model, cfg, scene, mesh, fns=sharded_fns))
        want.append(predict_scene_fused(model, cfg, scene, fns=fused_fns))
        evals["sharded"].update(got[-1].argmax(axis=1), scene.labels)
        evals["fused"].update(want[-1].argmax(axis=1), scene.labels)
    got, want = np.concatenate(got)[None], np.concatenate(want)[None]
    rule, band = agreement(got, want), agreement(got, want, tau=bf16_tie_band(want))
    top2 = np.partition(want[0], -2, axis=-1)
    margin = (top2[:, -1] - top2[:, -2]) / np.maximum(np.abs(top2[:, -1]), 1e-6)
    differ = got[0].argmax(-1) != want[0].argmax(-1)
    return {"space": space, "agreement": rule["agreement"], "points": want.shape[1],
            "confident_agreement": rule["confident_agreement"], "band_agreement": band["confident_agreement"],
            "band_share": band["confident_share"],
            "differ_max_rel_margin": float(margin[differ].max()) if differ.any() else 0.0,
            "median_abs_logit": float(np.median(np.abs(want))),
            "miou_sharded": evals["sharded"].results()["miou"], "miou_fused": evals["fused"].results()["miou"]}


def train_overrides(steps: int, seed: int, val_every: int | None = None) -> list:
    """The recipe's training policy for a stage of ``steps`` steps:
    validation (10 batches) every ``val_every`` steps (by default at the half
    and at the end), one checkpoint at the end, a log line every 20 steps."""
    return [
        f"train.max_steps={steps}",
        f"train.val_every={val_every or max(steps // 2, 1)}",
        "train.val_steps=10",
        f"train.ckpt_every={steps}",
        "train.log_every=20",
        "train.donate=true",
        f"train.seed={seed}",
    ]


def stage_configs(out: str, steps_2d: int, steps_3d: int, scenes: int, objects: int, seed: int = 0,
                  opts=()) -> tuple:
    """The two training stages' configs, as ``tools/e2e_run.py`` builds
    them (``train.seed`` added), under ``out``/sem_seg_2d and
    ``out``/mvpnet_3d; ``opts`` override both."""
    from mvpnet_torch.config import load_config

    data = [
        "data.name=synthetic",
        "data.num_classes=20",
        f"data.synthetic_scenes={scenes}",
        f"data.synthetic_objects={objects}",
    ]
    out2d = f"{out}/sem_seg_2d"
    cfg2d = load_config(None, [
        "model.name=sem_seg_2d",
        "data.sampling=frames",
        *train_overrides(steps_2d, seed, val_every=steps_2d),
        f"output_dir={out2d}",
    ] + data + list(opts))
    cfg3d = load_config(None, [
        "model.name=mvpnet_3d",
        f"model.pretrained_2d={out2d}/checkpoints",
        *train_overrides(steps_3d, seed),
        f"output_dir={out}/mvpnet_3d",
    ] + data + list(opts))
    return cfg2d, cfg3d


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default="outputs/e2e_run")
    ap.add_argument("--steps-2d", type=int, default=300)
    ap.add_argument("--steps-3d", type=int, default=300)
    ap.add_argument("--eval-scenes", type=int, default=2)
    ap.add_argument("--scenes", type=int, default=4, help="synthetic training scenes (data.synthetic_scenes)")
    ap.add_argument("--objects", type=int, default=6, help="objects a synthetic scene (data.synthetic_objects)")
    ap.add_argument("--seed", type=int, default=0,
                    help="train.seed of both stages; it also seeds the synthetic training and validation scenes "
                    "(the held-out scenes are fixed)")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("opts", nargs="*", help="key=value overrides of both stages")
    args = ap.parse_intermixed_args(argv)
    import torch

    from mvpnet_torch.data.pipeline import build_dataset
    from mvpnet_torch.entry import resolve_device
    from mvpnet_torch.eval.whole_scene import evaluate_scenes
    from mvpnet_torch.train.loop import train

    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    cfg2d, cfg3d = stage_configs(args.out, args.steps_2d, args.steps_3d, args.scenes, args.objects, args.seed,
                                 args.opts)
    seconds, launches = {}, {}

    def stage(name, fn):
        out, seconds[name], launches[name] = measured(device, fn)
        return out

    # ---- stage 1: frame-level 2D pretraining ----
    _, val2d = stage("train_2d", lambda: train(cfg2d, resume=False, device=device))
    print("2D pretrain val:", val2d["miou"], flush=True)

    # ---- stage 2: 3D fusion training, warm-started from stage 1 ----
    model, val3d = stage("train_3d", lambda: train(cfg3d, resume=False, device=device))
    print("3D train val:", val3d["miou"], flush=True)

    # ---- stage 3: whole-scene evaluation on held-out scenes ----
    scenes = list(build_dataset(cfg3d.data, batch_size=1, training=False, seed=123).scenes)[: args.eval_scenes]
    counts = class_counts(scenes, cfg3d.data.num_classes)
    model.eval()
    with torch.no_grad():
        single = stage("whole_scene", lambda: evaluate_scenes(model, cfg3d, scenes, batch_size=4))
        print("single-device whole-scene:", single["miou"], flush=True)
        # ---- stage 4: the sharded estimator against the fused one ----
        sharded = stage("whole_scene_sharded", lambda: compare_estimators(model, cfg3d, scenes))
    print("sharded vs fused whole-scene:", sharded, flush=True)

    results = {
        "val_2d_miou": float(val2d["miou"]),
        "val_3d_miou": float(val3d["miou"]),
        "whole_scene_single": single,
        "whole_scene_sharded": sharded,
        "steps_2d": args.steps_2d,
        "steps_3d": args.steps_3d,
        "eval_scenes": len(scenes),
        "seed": args.seed,
        "zero_iou_classes": sum(iou == 0.0 for iou, n in zip(single["class_iou"].values(), counts) if n),
        "absent_classes": [name for name, n in zip(single["class_iou"], counts) if not n],
        "devices": card_line(device),
        "seconds": seconds,
        "launches": launches,
    }
    with open(f"{args.out}/results.json", "w") as f:
        json.dump(results, f, indent=2)
    # keep the artifact small: configs, metrics and logs stay, checkpoints go
    for sub in (cfg2d.output_dir, cfg3d.output_dir):
        shutil.rmtree(f"{sub}/checkpoints", ignore_errors=True)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
