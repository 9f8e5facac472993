"""CLI: pretrain the 2D semantic-segmentation UNet on one GPU.

Counterpart of ``python -m mvpnet_tpu.cli.train_2d``: trains ``sem_seg_2d``
on the whole frame corpus with random frame sampling and 2D augmentation
(``data/frames.py``). The last checkpoint of this run warm-starts the 3D
fusion training (``model.pretrained_2d=<output_dir>/checkpoints``):

  python -m mvpnet_torch.cli.train_2d --cfg configs/scannet/sem_seg_2d_unet_resnet34.yaml \
      data.name=synthetic train.max_steps=1000

Arguments as ``cli.train_3d``'s (``--no-resume``, ``--device``, dotted
overrides).
"""
from __future__ import annotations

from mvpnet_torch.cli.train_3d import parse_args
from mvpnet_torch.config import load_config
from mvpnet_torch.train.loop import train


def main(argv=None):
    args = parse_args(argv)
    cfg = load_config(args.cfg, ["model.name=sem_seg_2d", "data.sampling=frames"] + list(args.opts))
    return train(cfg, resume=not args.no_resume, device=args.device)


if __name__ == "__main__":
    main()
