"""CLI: train a 3D model (the fusion model or the PointNet++ baseline).

Counterpart of ``python -m mvpnet_tpu.cli.train_3d``:

  python -m mvpnet_torch.cli.train_3d --cfg configs/scannet/mvpnet_3d_unet_resnet34_pn2ssg.yaml \
      data.name=synthetic train.max_steps=100 [solver.base_lr=2e-3 ...]
  python -m mvpnet_torch.cli.train_3d --cfg configs/scannet/pn2ssg_rgb.yaml data.name=synthetic

Checkpoints, ``log.txt`` and ``metrics.jsonl`` go to ``cfg.output_dir``; a
run resumes from its latest checkpoint unless ``--no-resume``. ``--device
cpu`` runs on the CPU (tiny configs only). On several GPUs (or CPU ranks)
the same command runs under PyTorch's launcher, one process a rank, with
the mesh in ``mesh.data`` / ``mesh.space`` (``train/loop.py``):

  python -m torch.distributed.run --standalone --nproc_per_node 2 -m mvpnet_torch.cli.train_3d \
      --cfg configs/scannet/mvpnet_3d_unet_resnet34_pn2ssg.yaml data.name=synthetic mesh.data=2
"""
from __future__ import annotations

import argparse

from mvpnet_torch.config import load_config
from mvpnet_torch.dist import bootstrap
from mvpnet_torch.train.loop import train


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cfg", default=None, help="YAML config overlay")
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("opts", nargs="*", help="dotted overrides, e.g. train.max_steps=1000")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = load_config(args.cfg, args.opts)
    if cfg.model.name not in ("mvpnet_3d", "pn2ssg"):
        raise SystemExit(f"train_3d expects a 3D model, got {cfg.model.name}")
    return train(cfg, resume=not args.no_resume, device=args.device)


if __name__ == "__main__":
    try:
        main()
    finally:
        bootstrap.shutdown()
