"""Three diagnostics of the port's synthetic recipe run (mvpnet_torch/e2e_run.py).

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

    python scripts/torch_e2e_probe.py r5-deterministic [--bf16-products] --out runs/torch_e2e/f3_bf16_seed0 \\
        --steps-2d 1500 --steps-3d 2500 --eval-scenes 4 --scenes 16 --objects 12 --seed 0

runs ``r5-corpus``'s run in the deterministic mode (``train.deterministic=true``,
one data worker, ``CUBLAS_WORKSPACE_CONFIG`` set before torch starts). With
``--bf16-products`` the two f32 products that feed the fusion kNN round
their inputs to bf16 and keep f32 products and sums, as a TPU's default
matmul precision does to ``mvpnet_tpu/core/camera.py:51`` (the lift's
rotation) and ``mvpnet_tpu/core/augment.py:34`` (the augmentation's
rotation): inside this probe only (``bf16_products``), the package's code
unchanged. ``results.json`` gains ``"deterministic": true`` and
``"bf16_products"``.

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


DETERMINISTIC = ["train.deterministic=true", "data.num_workers=1"]


def _bf16(t):
    """``t`` rounded to bf16 (nearest even) and back to its dtype."""
    import torch

    return t.to(torch.bfloat16).to(t.dtype)


@contextlib.contextmanager
def bf16_products():
    """The lift's rotation (``core.camera.world_from_camera``) and the
    augmentation's (the ``torch.matmul`` of ``core.augment``) take their
    inputs rounded to bf16, products and sums in f32."""
    import torch

    from mvpnet_torch.core import augment, camera

    world_from_camera = camera.world_from_camera

    def rounded_world_from_camera(xyz_cam, pose):
        x, y, z = (_bf16(xyz_cam[..., i]) for i in range(3))
        rows = []
        for i in range(3):
            r = pose[..., i, :][..., None, None, :]
            rot = _bf16(r[..., :3])  # the einsum's operand; the translation adds in f32 after it
            rows.append(((rot[..., 0] * x + rot[..., 1] * y) + rot[..., 2] * z) + r[..., 3])
        return torch.stack(rows, dim=-1)

    class _RoundedTorch:
        def __getattr__(self, name):
            return getattr(torch, name)

        @staticmethod
        def matmul(a, b):
            return torch.matmul(_bf16(a), _bf16(b))

    camera.world_from_camera = rounded_world_from_camera
    augment.torch = _RoundedTorch()
    try:
        yield
    finally:
        camera.world_from_camera = world_from_camera
        augment.torch = torch


def deterministic_run(argv) -> dict:
    rounded = "--bf16-products" in argv
    argv = [a for a in argv if a != "--bf16-products"] + DETERMINISTIC
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products stay f32
    with bf16_products() if rounded else contextlib.nullcontext():
        results = r5_run(argv)
    out = argv[argv.index("--out") + 1] if "--out" in argv else "outputs/e2e_run"
    results.update(deterministic=True, bf16_products=rounded)
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
    commands = {"r5-corpus": r5_run, "r5-deterministic": deterministic_run, "estimators": estimators}
    if not argv or argv[0] not in commands:
        raise SystemExit(__doc__)
    return commands[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
