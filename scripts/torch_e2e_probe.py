"""Two diagnostics of the port's synthetic recipe run (mvpnet_torch/e2e_run.py).

    python scripts/torch_e2e_probe.py r5-corpus --out runs/torch_e2e/r5_seed0 \\
        --steps-2d 1500 --steps-3d 2500 --eval-scenes 4 --scenes 16 --objects 12 --seed 0

runs ``e2e_run.main`` with its arguments on the synthetic scenes that the JAX
package's run of record (``runs/r5_e2e``) drew. That run predates the JAX
package's interleaved scene seeds: scene i of ``build_dataset(..., seed=s)``
was seeded s * 1000 + i, plus 500 for validation (now s * 1_000_000 + 2 i,
plus 1). The generator is the same; only the draws differ. ``results.json``
gains ``"r5_corpus": true``.

    python scripts/torch_e2e_probe.py estimators --out outputs/e2e_estimators --seed 0

trains the recipe's two stages as ``e2e_run`` does (the run of record's
sizes by default), then holds the space-sharded estimator against the fused
one (``e2e_run.compare_estimators``) on the held-out scenes with the trained
weights twice: in the config's bf16, and in f32 (``model.unet.dtype``,
``model.pn2.dtype``). It writes ``<out>/estimators.json`` and deletes the
checkpoints.

Run from the repository's root; ``--device cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

F32 = ["model.unet.dtype=float32", "model.pn2.dtype=float32"]


@contextlib.contextmanager
def r5_corpus():
    """``build_dataset`` draws the scenes of the JAX run of record."""
    from mvpnet_torch.data import pipeline

    make_scene = pipeline.make_scene

    def r5_make_scene(*, seed: int, **kw):
        base, rest = divmod(seed, 1_000_000)
        i, val = divmod(rest, 2)
        return make_scene(seed=base * 1000 + i + 500 * val, **kw)

    pipeline.make_scene = r5_make_scene
    try:
        yield
    finally:
        pipeline.make_scene = make_scene


def r5_run(argv) -> dict:
    from mvpnet_torch import e2e_run

    with r5_corpus():
        results = e2e_run.main(argv)
    out = argv[argv.index("--out") + 1] if "--out" in argv else "outputs/e2e_run"
    results["r5_corpus"] = True
    with open(f"{out}/results.json", "w") as f:
        json.dump(results, f, indent=2)
    return results


def estimators(argv) -> dict:
    import torch

    from mvpnet_torch import e2e_run
    from mvpnet_torch.cli.test_3d import restore
    from mvpnet_torch.data.pipeline import build_dataset
    from mvpnet_torch.entry import resolve_device
    from mvpnet_torch.train.loop import train

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="outputs/e2e_estimators")
    ap.add_argument("--steps-2d", type=int, default=1500)
    ap.add_argument("--steps-3d", type=int, default=2500)
    ap.add_argument("--eval-scenes", type=int, default=4)
    ap.add_argument("--scenes", type=int, default=16)
    ap.add_argument("--objects", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    ap.add_argument("opts", nargs="*")
    args = ap.parse_intermixed_args(argv)

    device = resolve_device(args.device)
    sizes = (args.steps_2d, args.steps_3d, args.scenes, args.objects, args.seed)
    cfg2d, cfg3d = e2e_run.stage_configs(args.out, *sizes, args.opts)
    train(cfg2d, resume=False, device=device)
    _, val3d = train(cfg3d, resume=False, device=device)
    scenes = list(build_dataset(cfg3d.data, batch_size=1, training=False, seed=123).scenes)[: args.eval_scenes]
    results = {"val_3d_miou": float(val3d["miou"]), "seed": args.seed, "eval_scenes": len(scenes),
               "devices": e2e_run.card_line(device)}
    with torch.no_grad():
        for name, cfg in (("bf16", cfg3d), ("f32", e2e_run.stage_configs(args.out, *sizes, [*args.opts, *F32])[1])):
            model, _ = restore(cfg, device)
            results[name] = e2e_run.compare_estimators(model, cfg, scenes)
            print(name, json.dumps(results[name]), flush=True)
    with open(f"{args.out}/estimators.json", "w") as f:
        json.dump(results, f, indent=2)
    for sub in (cfg2d.output_dir, cfg3d.output_dir):
        shutil.rmtree(f"{sub}/checkpoints", ignore_errors=True)
    return results


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in ("r5-corpus", "estimators"):
        raise SystemExit(__doc__)
    return (r5_run if argv[0] == "r5-corpus" else estimators)(argv[1:])


if __name__ == "__main__":
    main()
