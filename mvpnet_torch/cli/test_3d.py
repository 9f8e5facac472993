"""CLI: whole-scene sliding-window evaluation of a trained 3D model.

Counterpart of ``python -m mvpnet_tpu.cli.test_3d``: restore the latest
checkpoint under ``<output_dir>/checkpoints``, slide chunk windows over each
validation scene, accumulate logits, print the results (per-class IoU,
mIoU, accuracy) as one JSON line, and optionally export ScanNet
benchmark .txt files (NYU40 ids, one file a scene):

  python -m mvpnet_torch.cli.test_3d --cfg configs/scannet/mvpnet_3d_unet_resnet34_pn2ssg.yaml \
      data.name=synthetic --export outputs/export [--batch-size 4] [--fused]

``--device cpu`` runs on the CPU (tiny configs only). ``--sharded`` is not
ported yet and raises.
"""
from __future__ import annotations

import argparse
import json

from mvpnet_torch.config import load_config
from mvpnet_torch.data.pipeline import build_dataset
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
    ap.add_argument("--sharded", action="store_true", help="space-sharded whole-scene inference (not ported yet)")
    ap.add_argument("--fused", action="store_true",
                    help="single-device scene-view-set inference with a prepared pixel cloud (eval/scene_fused.py)")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("opts", nargs="*")
    args = ap.parse_args(argv)

    cfg = load_config(args.cfg, args.opts)
    if args.sharded or cfg.eval.sharded:
        raise NotImplementedError(
            "--sharded: the space-sharded whole-scene estimator is not ported yet (ROADMAP.md Queue 1, multi-GPU)"
        )
    dev = resolve_device(args.device)
    logger = setup_logger(output_dir=cfg.output_dir)
    model, step = restore(cfg, dev)
    logger.info("restored checkpoint step=%s", step)
    ds = build_dataset(cfg.data, batch_size=1, training=False, seed=0)
    results = evaluate_scenes(
        model,
        cfg,
        ds.scenes,
        batch_size=args.batch_size or cfg.eval.batch_size,
        export_dir=args.export,
        fused=args.fused or cfg.eval.fused,
    )
    logger.info("results: %s", json.dumps(results, indent=2))
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
