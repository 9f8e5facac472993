"""CLI: evaluate the 2D semantic-segmentation UNet on the validation frames.

Counterpart of ``python -m mvpnet_tpu.cli.test_2d``: restore the latest
``sem_seg_2d`` checkpoint under ``<output_dir>/checkpoints``, make one
in-order pass over every frame of the validation scenes
(``FrameDataset.iter_epoch``; every labeled pixel counts, no depth mask) and
print pixel accuracy, per-class IoU and mIoU as one JSON line:

  python -m mvpnet_torch.cli.test_2d --cfg configs/scannet/sem_seg_2d_unet_resnet34.yaml \
      data.name=synthetic [--batch-size 16]

``--device cpu`` runs on the CPU (tiny configs only).
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from mvpnet_torch.cli.test_3d import restore
from mvpnet_torch.config import load_config
from mvpnet_torch.data.frames import FrameDataset
from mvpnet_torch.data.pipeline import build_dataset
from mvpnet_torch.entry import resolve_device
from mvpnet_torch.eval.whole_scene import Evaluator
from mvpnet_torch.utils.logger import setup_logger


def evaluate_frames(model, cfg, scenes, *, batch_size: int) -> dict:
    """Results of ``Evaluator`` over one pass of ``iter_epoch`` on the
    frames of ``scenes``, the padding rows left out (``n_real``)."""
    dev = next(model.parameters()).device

    @torch.no_grad()
    def forward(images):
        # SemSeg2D takes the batch dict with a views axis
        _, logits = model({"images": torch.from_numpy(images).to(dev)[:, None]})
        return logits[:, 0]

    frames = FrameDataset(scenes, cfg.data, batch_size=batch_size, training=False)
    evaluator = Evaluator(cfg.data.num_classes, cfg.data.ignore_label)
    for batch in frames.iter_epoch():
        n = batch.pop("n_real")
        imgs = batch["images"]
        scale = 255.0 if imgs.dtype == np.uint8 else 1.0
        pred = forward(imgs.astype(np.float32) / scale)[:n].argmax(-1).cpu().numpy()
        evaluator.update(pred, batch["seg_label_2d"][:n])
    return evaluator.results()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cfg", default=None)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("opts", nargs="*")
    args = ap.parse_args(argv)

    cfg = load_config(args.cfg, ["model.name=sem_seg_2d"] + list(args.opts))
    dev = resolve_device(args.device)
    logger = setup_logger(output_dir=cfg.output_dir)
    model, step = restore(cfg, dev)
    logger.info("restored checkpoint step=%s", step)
    ds = build_dataset(cfg.data, batch_size=1, training=False, seed=0)
    results = evaluate_frames(model, cfg, ds.scenes, batch_size=args.batch_size)
    logger.info("2D results: %s", json.dumps(results, indent=2))
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
