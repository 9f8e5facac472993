"""Two diagnostics of the port's point-budget robustness sweep
(mvpnet_torch/robustness.py), for the gap between its fusion model's
retention at 1024 points and the JAX package's (runs/r5_robustness.json).

    python scripts/robustness_probe.py checkpoints --out outputs/robustness_probe

trains the sweep's 2D and fusion stages as ``robustness.main`` does with
seed 0 (1500 steps each), the fusion stage keeping a checkpoint and a chunk
validation every 150 steps, then evaluates the fusion model at every
checkpoint and every budget on each of the 8 held-out scenes alone (one
confusion matrix a scene and budget): how its retention at the smallest
budget moves with its full-budget mIoU as it trains, and how far it moves
with the choice of scenes. Each checkpoint's record holds the mIoU by budget
and the retention (mIoU at 1024 over mIoU at 8192) of the first 4 scenes
pooled (the sweep's number), of the other 4, of all 8, and of each scene
alone. The last checkpoint is also evaluated so on the held-out scenes as
JAX's round-5 runs drew them (``torch_e2e_probe.r5_corpus``). It writes
``<out>/probe.json`` and deletes the checkpoints. Run on the card.

    python scripts/robustness_probe.py parity --out runs/torch_robustness/parity_narrow.json

holds the port's ``predict_scene`` to the JAX package's on the CPU, both
with the same random weights (one JAX train-mode forward gives every BN
nontrivial statistics), at the sweep's geometry: its chunks of 1.5 m, its
budgets 8192 down to 1024, its four SA levels (npoint 1024 / 256 / 64 / 16,
radii 0.1 / 0.2 / 0.4 / 0.8, 32 samples), with the networks narrowed and
the views cut to 30x40 (``NARROW``) so that the CPU runs it in minutes. Each
budget is held to tests/test_torch_eval.py's scene rule (argmax agreement >
0.995, logits within 5e-3 x scale x the largest window count); it exits
nonzero when a budget misses it. At random weights both packages score an
mIoU near 0, so the mIoUs it records say nothing of a fault: the logit bound
is the evidence. With ``--direct-distances`` the JAX package's ball query
and kNN take their squared distances as the port does, (dx*dx + dy*dy) +
dz*dz, where its reference expands |a|^2 - 2ab + |b|^2 (``ROADMAP.md``
Queue 3, "Distance form"): inside this probe only (``direct_distances``),
the package's code unchanged.

Run from the repository's root.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))
sys.path.insert(0, HERE)

SEED = 0  # train.seed of both stages
EVERY = 150  # fusion steps between checkpoints
HELD_OUT = 8  # the synthetic corpus's held-out scenes: half its 16 training scenes
THREADS = 4  # CPU threads of the parity mode
NARROW = [
    "data.image_height=30", "data.image_width=40",
    "model.unet.base_channels=8", "model.unet.stage_channels=[8,16,16,32]", "model.unet.stage_blocks=[1,1,1,1]",
    "model.unet.decoder_channels=[16,16,8,8]", "model.unet.feature_channels=8", "model.unet.dtype=float32",
    "model.aggregation.mlp_channels=[8,8]", "model.pn2.in_channels=8", "model.pn2.dtype=float32",
    "model.pn2.head_channels=16", "model.pn2.dropout=0.0",
    "model.pn2.sa=[{npoint: 1024, radius: 0.1, nsample: 32, mlp_channels: [8,16]},"
    " {npoint: 256, radius: 0.2, nsample: 32, mlp_channels: [16,16]},"
    " {npoint: 64, radius: 0.4, nsample: 32, mlp_channels: [16,32]},"
    " {npoint: 16, radius: 0.8, nsample: 32, mlp_channels: [32,32]}]",
    "model.pn2.fp_channels=[[32],[32],[32,16],[16,16]]",
]
PARITY_BATCH = 2  # windows a forward: JAX's plain fusion kNN holds B x N x V*H*W distances


def scene_matrices(model, cfg, scenes) -> dict:
    """Each scene's confusion matrix at every budget, the scene evaluated
    alone as ``evaluate_scenes`` evaluates it (batch 4)."""
    import torch

    from mvpnet_torch.eval.whole_scene import Evaluator, make_forward, predict_scene
    from mvpnet_torch.robustness import BUDGETS

    out = {}
    for budget in BUDGETS:
        cfg_b = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, num_points=budget))
        forward_fn = make_forward(model, cfg_b)
        out[str(budget)] = []
        for scene in scenes:
            ev = Evaluator(cfg.data.num_classes, cfg.data.ignore_label)
            with torch.no_grad():
                ev.update(predict_scene(model, cfg_b, scene, batch_size=4, forward_fn=forward_fn).argmax(1),
                          scene.labels)
            out[str(budget)].append(ev.cm)
    return out


def retention(matrices: dict) -> dict:
    """mIoU by budget and retention of the first 4 scenes pooled (the
    sweep's), of the other 4, of all, and of each scene alone."""
    import torch

    from mvpnet_torch.robustness import N_SCENES, relative
    from mvpnet_torch.train.metrics import iou_from_confusion

    def miou(sel):
        return {b: round(float(iou_from_confusion(torch.from_numpy(sum(cms[i] for i in sel)))[1]), 4)
                for b, cms in matrices.items()}

    n = len(next(iter(matrices.values())))
    out = {}
    for key, sel in (("first4", range(N_SCENES)), ("other4", range(N_SCENES, n)), ("all", range(n))):
        out[key] = {"miou": miou(sel), "relative_at_min_budget": relative(miou(sel))}
    out["each_scene_relative"] = [relative(miou([i])) for i in range(n)]
    return out


def checkpoints(out_dir: str) -> dict:
    import torch

    from mvpnet_torch import robustness
    from mvpnet_torch.e2e_run import card_line
    from mvpnet_torch.entry import resolve_device
    from mvpnet_torch.train.checkpoint import Checkpointer
    from mvpnet_torch.train.loop import train
    from torch_e2e_probe import r5_corpus

    device = resolve_device(None)
    runs = robustness.stage_configs(out_dir, seed=SEED)
    cfg3d = runs["mvpnet_3d"]
    steps = cfg3d.train.max_steps
    runs["mvpnet_3d"] = dataclasses.replace(cfg3d, train=dataclasses.replace(
        cfg3d.train, ckpt_every=EVERY, val_every=EVERY, ckpt_keep=steps // EVERY + 1))
    for name in ("sem_seg_2d", "mvpnet_3d"):
        train(runs[name], resume=False, device=device)
    with open(f"{out_dir}/mvpnet_3d/metrics.jsonl") as f:
        chunk_val = {r["step"]: r["val/miou"] for r in map(json.loads, f) if "val/miou" in r}
    out = {"devices": card_line(device), "seed": SEED, "steps_2d": runs["sem_seg_2d"].train.max_steps,
           "steps_3d": steps, "every": EVERY, "held_out_scenes": HELD_OUT, "checkpoints": {}}
    saved = Checkpointer(f"{out_dir}/mvpnet_3d/checkpoints").steps()
    scenes = None
    for step in saved:
        cfg, model, _ = robustness.restore("mvpnet_3d", out_dir, device=device, step=step)
        if scenes is None:
            scenes = robustness.eval_scenes(cfg, HELD_OUT)
            assert len(scenes) == HELD_OUT, len(scenes)
        row = retention(scene_matrices(model, cfg, scenes))
        out["checkpoints"][str(step + 1)] = {"chunk_val_miou": chunk_val.get(step + 1), **row}
        print(f"step {step + 1}: chunk val {chunk_val.get(step + 1)}, {row}", flush=True)
        if step == saved[-1]:
            with r5_corpus():
                r5_scenes = robustness.eval_scenes(cfg, HELD_OUT)
            out["r5_corpus_last"] = {"step": step + 1, **retention(scene_matrices(model, cfg, r5_scenes))}
            print(f"step {step + 1} on JAX's round-5 scenes: {out['r5_corpus_last']}", flush=True)
        del model
        torch.cuda.empty_cache()
    with open(f"{out_dir}/probe.json", "w") as f:
        json.dump(out, f, indent=2)
    for cfg in runs.values():
        shutil.rmtree(f"{cfg.output_dir}/checkpoints", ignore_errors=True)
    return out


def direct_distances():
    """The JAX reference's ``pairwise_sqdist`` in the port's form (its ball
    query and kNN read the module global when they are first traced)."""
    import jax.numpy as jnp

    from mvpnet_tpu.ops import reference

    def sqdist(a, b):
        a, b = a.astype(jnp.float32), b.astype(jnp.float32)
        dx, dy, dz = (a[..., :, None, i] - b[..., None, :, i] for i in range(3))
        return (dx * dx + dy * dy) + dz * dz

    reference.pairwise_sqdist = sqdist


def parity(out_path: str, direct: bool) -> dict:
    import jax
    import numpy as np
    import torch
    from flax import nnx

    from mvpnet_tpu.config import load_config as jax_load_config
    from mvpnet_tpu.data.pipeline import ChunkDataset
    from mvpnet_tpu.data.pipeline import build_dataset as jax_build_dataset
    from mvpnet_tpu.eval import whole_scene as jwhole
    from mvpnet_tpu.models import build_model as jax_build_model
    from mvpnet_tpu.train.step import prepare_batch as jax_prepare_batch
    from mvpnet_torch import convert, robustness
    from mvpnet_torch.eval import sharded_scene, whole_scene
    from mvpnet_torch.models import build_model
    from tests.test_torch_models import _flat_params

    torch.set_num_threads(THREADS)
    if direct:
        direct_distances()
    cfg = robustness.model_config("mvpnet_3d", "outputs/robustness_parity", NARROW)
    jcfg = jax_load_config(robustness.CONFIGS["mvpnet_3d"], robustness.COMMON + NARROW)
    jscene = jax_build_dataset(jcfg.data, batch_size=1, training=False, seed=0).scenes[0]
    scene = robustness.eval_scenes(cfg, 1)[0]
    np.testing.assert_array_equal(jscene.points, scene.points)
    jmodel = nnx.jit(lambda: jax_build_model(jcfg, rngs=nnx.Rngs(0))[0])()
    raw = next(iter(ChunkDataset([jscene], jcfg.data, batch_size=PARITY_BATCH, training=False, seed=3)))
    jmodel.train()
    nnx.jit(lambda m, b: m(jax_prepare_batch(jcfg, b, training=False)))(jmodel, jax.device_put(raw))
    jmodel.eval()
    model = build_model(cfg)[0]
    convert.load_jax_params(model, _flat_params(jmodel))
    model.eval()
    out, ok = {"points": len(scene.points), "direct_distances": direct, "budgets": {}}, True
    for budget in robustness.BUDGETS:
        cfg_b = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, num_points=budget))
        jcfg_b = dataclasses.replace(jcfg, data=dataclasses.replace(jcfg.data, num_points=budget))
        want = jwhole.predict_scene(jmodel, jcfg_b, jscene, batch_size=PARITY_BATCH)
        got = whole_scene.predict_scene(model, cfg_b, scene, batch_size=PARITY_BATCH)
        counts = np.zeros(len(scene.points), np.int64)
        for sel, _ in sharded_scene.enumerate_scene_chunks(scene, cfg_b):
            np.add.at(counts, sel, 1)
        scale = max(float(np.abs(want).max()), 1.0)
        row = {"argmax_agreement": float((got.argmax(1) == want.argmax(1)).mean()),
               "max_abs_diff": float(np.abs(got - want).max()), "scale": scale, "max_count": int(counts.max())}
        row["held"] = bool(row["argmax_agreement"] > 0.995
                           and row["max_abs_diff"] < 5e-3 * scale * max(row["max_count"], 1))
        for side, logits in (("port", got), ("jax", want)):
            ev = whole_scene.Evaluator(cfg.data.num_classes, cfg.data.ignore_label)
            ev.update(logits.argmax(1), scene.labels)
            row[f"miou_{side}"] = ev.results()["miou"]
        ok &= row["held"]
        out["budgets"][str(budget)] = row
        print(f"{budget} points: {row}", flush=True)
    out["held"] = ok
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=2)
    if not ok:
        raise SystemExit(f"the port and JAX disagree: {out}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="mode", required=True)
    sub.add_parser("checkpoints").add_argument("--out", default="outputs/robustness_probe")
    pa = sub.add_parser("parity")
    pa.add_argument("--out", default="runs/torch_robustness/parity_narrow.json")
    pa.add_argument("--direct-distances", action="store_true",
                    help="the JAX side's ball query and kNN distances as the port computes them")
    args = ap.parse_args(argv)
    return checkpoints(args.out) if args.mode == "checkpoints" else parity(args.out, args.direct_distances)


if __name__ == "__main__":
    main()
