"""CLI: whole-scene sliding-window evaluation of a trained 3D model.

Counterpart of ``python -m mvpnet_tpu.cli.test_3d``: restore the latest
checkpoint under ``<output_dir>/checkpoints``, slide chunk windows over each
validation scene, accumulate logits, print the results (per-class IoU,
mIoU, accuracy) as one JSON line, and optionally export ScanNet
benchmark .txt files (NYU40 ids, one file a scene):

  python -m mvpnet_torch.cli.test_3d --cfg configs/scannet/mvpnet_3d_unet_resnet34_pn2ssg.yaml \
      data.name=synthetic --export outputs/export [--batch-size 4] [--fused]

``--device cpu`` runs on the CPU (tiny configs only). ``--sharded`` (or
``eval.sharded``) runs the space-sharded estimator (eval/sharded_scene.py)
over ``cfg.mesh``: one process without a launcher (``space=1``), else one
rank a process under ``python -m torch.distributed.run`` (data ranks repeat
the work; rank 0 prints and exports):

  python -m torch.distributed.run --standalone --nproc_per_node 2 -m mvpnet_torch.cli.test_3d \
      --cfg configs/scannet/mvpnet_3d_unet_resnet34_pn2ssg.yaml data.name=synthetic --sharded mesh.space=2
"""
from __future__ import annotations

import argparse
import json

from mvpnet_torch import ops
from mvpnet_torch.config import load_config
from mvpnet_torch.data.pipeline import build_dataset
from mvpnet_torch.dist import bootstrap
from mvpnet_torch.dist.mesh import make_mesh
from mvpnet_torch.entry import resolve_device
from mvpnet_torch.eval.whole_scene import evaluate_scenes
from mvpnet_torch.models.build import build_model
from mvpnet_torch.train.checkpoint import Checkpointer
from mvpnet_torch.utils.logger import setup_logger


def restore(cfg, device):
    """The model of ``cfg`` with the latest checkpoint under
    ``<output_dir>/checkpoints``, in eval mode on ``device``; SystemExit
    when there is none (never random weights)."""
    model, _, _ = build_model(cfg)
    step = Checkpointer(f"{cfg.output_dir}/checkpoints").restore(model)
    if step is None:
        raise SystemExit(
            f"no checkpoint found under {cfg.output_dir}/checkpoints — "
            "train first or point output_dir at a trained run"
        )
    return model.to(device).eval(), step


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cfg", default=None)
    ap.add_argument("--export", default=None, help="benchmark export dir")
    ap.add_argument("--batch-size", type=int, default=None, help="chunk windows a forward (default: eval.batch_size)")
    ap.add_argument("--sharded", action="store_true",
                    help="space-sharded whole-scene inference over the cfg.mesh space axis (eval/sharded_scene.py)")
    ap.add_argument("--fused", action="store_true",
                    help="single-device scene-view-set inference with a prepared pixel cloud (eval/scene_fused.py)")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("opts", nargs="*")
    args = ap.parse_args(argv)

    cfg = load_config(args.cfg, args.opts)
    dev = resolve_device(args.device)
    mesh = None
    if args.sharded or cfg.eval.sharded:
        bootstrap.initialize(device=args.device)  # no launcher: one process
        dev = bootstrap.device() or dev
        mesh = make_mesh(cfg.mesh)
    primary = bootstrap.is_primary()
    logger = setup_logger(output_dir=cfg.output_dir if primary else None)
    model, step = restore(cfg, dev)
    logger.info("restored checkpoint step=%s", step)
    if mesh is not None:
        logger.info("sharded whole-scene eval over mesh %s (%s)", mesh.shape, bootstrap.describe())
    ds = build_dataset(cfg.data, batch_size=1, training=False, seed=0)
    results = evaluate_scenes(
        model,
        cfg,
        ds.scenes,
        batch_size=args.batch_size or cfg.eval.batch_size,
        export_dir=args.export if primary else None,
        mesh=mesh,
        fused=args.fused or cfg.eval.fused,
    )
    if primary:
        logger.info("kernel launches since start: %s", ops.launch_counts())
        logger.info("results: %s", json.dumps(results, indent=2))
        print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    try:
        main()
    finally:
        bootstrap.shutdown()
