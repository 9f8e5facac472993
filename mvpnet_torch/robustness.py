"""Robustness under point subsampling: the fusion model against the xyz-only
PointNet++ baseline.

Counterpart of ``tools/r5_robustness.py``. The paper states that MVPNet
degrades gracefully under point subsampling while geometry-only baselines
drop steeply (BASELINE.md). This evaluates the trained fusion model
(``mvpnet_3d``) and the xyz-only PN2SSG (``pn2ssg_xyz``) on the same held-out
synthetic scenes at chunk point budgets of 8192 down to 1024 (1024 is SA1's
npoint) and writes each model's whole-scene mIoU at each budget.

The tool leaves its three training runs to its user; here ``main`` runs them
first (``stage_configs``), so the result comes from one command:

  1. frame-level 2D pretraining, ``e2e_run.stage_configs``' first stage on
     the tool's corpus (16 scenes x 12 objects), under ``<out>/sem_seg_2d``;
  2. ``mvpnet_3d`` (``configs/scannet/mvpnet_3d_unet_resnet34_pn2ssg.yaml``)
     warm-started from stage 1, under ``<out>/mvpnet_3d``;
  3. ``pn2ssg_xyz`` (``configs/scannet/pn2ssg_xyz.yaml``, no input features),
     under ``<out>/pn2ssg_xyz``.

JAX's run restored both models at step 1499 (``runs/r5_robustness.json``) and
its loop saves at ``step + 1 == max_steps``, so both trained 1500 steps. It did
not record its 2D step count; 1500 is that of its recipe run (``runs/r5_e2e``).

The sweep (``sweep``) is the tool's ``main``: each model is built from its
YAML plus ``COMMON`` (``model_config``) and restored from its stage's
checkpoint (``restore``), then evaluated with ``evaluate_scenes`` (batch 4)
at each budget (``curve``) on the first ``N_SCENES`` scenes of
``build_dataset(..., training=False, seed=0)`` (``eval_scenes``). Scene
generation reads no ``num_points``, so those scenes are built once and serve
every budget and both models.

``<out>/results.json`` holds JAX's keys (``budgets``; ``models.<name>`` with
``restored_step``, ``miou`` by budget and ``relative_at_min_budget``;
``fusion_degrades_more_gracefully``) plus ``devices`` (the card's name and
power limit as nvidia-smi gives them), ``seed``, ``eval_scenes``,
``steps_2d``, ``steps_3d``, ``val_2d_miou``, ``val_3d_miou``,
``val_pn2ssg_xyz_miou``, ``seconds`` and ``launches`` (each training stage's,
and each model's at each budget under ``eval``). Each stage keeps its
``config.yaml``, ``metrics.jsonl`` and ``log.txt``; the checkpoints are
deleted afterwards.

    python -m mvpnet_torch.robustness --out runs/torch_robustness/seed0 \\
        --steps-2d 1500 --steps-3d 1500 --seed 0

``--steps-3d`` sets both the fusion model's and the baseline's steps.
Trailing ``key=value`` overrides apply to every stage and to the sweep's
configs (the tests' tiny widths); ``--device cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil

BUDGETS = (8192, 4096, 2048, 1024)
N_SCENES = 4
SCENES, OBJECTS = 16, 12  # the synthetic training corpus
COMMON = [
    "data.name=synthetic",
    "data.num_classes=20",
    f"data.synthetic_scenes={SCENES}",
    f"data.synthetic_objects={OBJECTS}",
]
STEPS = 1500
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {
    "mvpnet_3d": os.path.join(_ROOT, "configs", "scannet", "mvpnet_3d_unet_resnet34_pn2ssg.yaml"),
    "pn2ssg_xyz": os.path.join(_ROOT, "configs", "scannet", "pn2ssg_xyz.yaml"),
}
# overrides applied after the caller's: the baseline takes no input features,
# whatever the overrides give the fusion model's PointNet++
PINNED = {"mvpnet_3d": [], "pn2ssg_xyz": ["model.pn2.in_channels=0"]}


def model_config(name: str, out: str, opts=(), extra=()):
    """``name``'s YAML plus COMMON, ``extra``, its output directory under
    ``out``, ``opts`` and its PINNED overrides."""
    from mvpnet_torch.config import load_config

    return load_config(CONFIGS[name], COMMON + list(extra) + [f"output_dir={out}/{name}"] + list(opts) + PINNED[name])


def stage_configs(out: str, steps_2d: int = STEPS, steps_3d: int = STEPS, seed: int = 0, opts=()) -> dict:
    """The three training runs the sweep restores, by output directory name:
    ``sem_seg_2d``, ``mvpnet_3d`` (warm-started from the first) and
    ``pn2ssg_xyz``, under ``out``; ``opts`` override all three."""
    from mvpnet_torch.e2e_run import stage_configs as e2e_stage_configs
    from mvpnet_torch.e2e_run import train_overrides

    cfg2d = e2e_stage_configs(out, steps_2d, steps_3d, SCENES, OBJECTS, seed, opts)[0]
    train = train_overrides(steps_3d, seed)
    return {
        "sem_seg_2d": cfg2d,
        "mvpnet_3d": model_config("mvpnet_3d", out, opts,
                                  [f"model.pretrained_2d={cfg2d.output_dir}/checkpoints"] + train),
        "pn2ssg_xyz": model_config("pn2ssg_xyz", out, opts, train),
    }


def degrades_more_gracefully(models: dict) -> bool:
    """The claim under test: the fusion model keeps a larger share of its
    full-budget mIoU at the smallest budget than the xyz-only baseline."""
    rel = {k: v["relative_at_min_budget"] for k, v in models.items()}
    return bool(rel.get("mvpnet_3d", 0) > rel.get("pn2ssg_xyz", 1))


def restore(name: str, out: str, opts=(), device=None, step: int | None = None):
    """``name``'s model (``model_config``) on ``device``, restored from
    ``<out>/<name>/checkpoints`` at ``step`` (the latest by default) and put
    in eval mode. Returns (cfg, model, restored step)."""
    from mvpnet_torch.models import build_model
    from mvpnet_torch.train.checkpoint import Checkpointer

    cfg = model_config(name, out, opts)
    model = build_model(cfg, seed=0)[0].to(device)
    step = Checkpointer(f"{cfg.output_dir}/checkpoints").restore(model, step=step)
    if step is None:
        raise FileNotFoundError(f"no checkpoint for {name} under {cfg.output_dir}")
    return cfg, model.eval(), step


def curve(model, cfg, scenes, device) -> tuple[dict, dict, dict]:
    """``model``'s whole-scene mIoU over ``scenes`` at every budget (4 places),
    and each evaluation's seconds and kernel launches, keyed by budget."""
    import torch

    from mvpnet_torch.e2e_run import measured
    from mvpnet_torch.eval.whole_scene import evaluate_scenes

    miou, seconds, launches = {}, {}, {}
    for budget in BUDGETS:
        cfg_b = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, num_points=budget))
        with torch.no_grad():
            res, seconds[str(budget)], launches[str(budget)] = measured(
                device, lambda: evaluate_scenes(model, cfg_b, scenes, batch_size=4))
        miou[str(budget)] = round(float(res["miou"]), 4)
    return miou, seconds, launches


def relative(miou: dict) -> float:
    """mIoU at the smallest budget over mIoU at the largest, 3 places."""
    return round(miou[str(BUDGETS[-1])] / max(miou[str(BUDGETS[0])], 1e-9), 3)


def eval_scenes(cfg, n_scenes: int = N_SCENES) -> list:
    """The first ``n_scenes`` held-out scenes, as the tool draws them."""
    from mvpnet_torch.data.pipeline import build_dataset

    return list(build_dataset(cfg.data, batch_size=1, training=False, seed=0).scenes)[:n_scenes]


def sweep(out: str, opts=(), n_scenes: int = N_SCENES, device=None) -> tuple[dict, dict, dict]:
    """Each model restored from ``<out>/<name>/checkpoints`` and evaluated at
    every budget. Returns (JAX's result dict, seconds and launches of each
    evaluation by model and budget)."""
    from mvpnet_torch.entry import resolve_device

    device = resolve_device(device)
    scenes = None
    result, seconds, launches = {"budgets": list(BUDGETS), "models": {}}, {}, {}
    for name in CONFIGS:
        cfg, model, step = restore(name, out, opts, device)
        scenes = scenes or eval_scenes(cfg, n_scenes)
        miou, seconds[name], launches[name] = curve(model, cfg, scenes, device)
        print(f"{name}: mIoU by budget {miou}", flush=True)
        result["models"][name] = {"restored_step": int(step), "miou": miou, "relative_at_min_budget": relative(miou)}
        del model
    result["fusion_degrades_more_gracefully"] = degrades_more_gracefully(result["models"])
    return result, seconds, launches


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default="outputs/robustness")
    ap.add_argument("--steps-2d", type=int, default=STEPS)
    ap.add_argument("--steps-3d", type=int, default=STEPS, help="steps of the fusion model and of the baseline")
    ap.add_argument("--eval-scenes", type=int, default=N_SCENES)
    ap.add_argument("--seed", type=int, default=0, help="train.seed of every stage")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("opts", nargs="*", help="key=value overrides of every stage and of the sweep")
    args = ap.parse_intermixed_args(argv)

    from mvpnet_torch.e2e_run import card_line, measured
    from mvpnet_torch.entry import resolve_device
    from mvpnet_torch.train.loop import train

    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    runs = stage_configs(args.out, args.steps_2d, args.steps_3d, args.seed, args.opts)
    seconds, launches, val = {}, {}, {}
    for name, stage in zip(runs, ("train_2d", "train_3d", "train_pn2ssg_xyz")):
        (_, metrics), seconds[stage], launches[stage] = measured(
            device, lambda: train(runs[name], resume=False, device=device))
        val[name] = float(metrics["miou"])
        print(f"{name} val:", val[name], flush=True)

    results, seconds["eval"], launches["eval"] = sweep(args.out, args.opts, args.eval_scenes, device)
    results.update({
        "devices": card_line(device),
        "seed": args.seed,
        "eval_scenes": args.eval_scenes,
        "steps_2d": args.steps_2d,
        "steps_3d": args.steps_3d,
        "val_2d_miou": val["sem_seg_2d"],
        "val_3d_miou": val["mvpnet_3d"],
        "val_pn2ssg_xyz_miou": val["pn2ssg_xyz"],
        "seconds": seconds,
        "launches": launches,
    })
    with open(f"{args.out}/results.json", "w") as f:
        json.dump(results, f, indent=2)
    # keep the artifact small: configs, metrics and logs stay, checkpoints go
    for cfg in runs.values():
        shutil.rmtree(f"{cfg.output_dir}/checkpoints", ignore_errors=True)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
