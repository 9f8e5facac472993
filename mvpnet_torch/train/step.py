"""Device-side batch preparation.

Counterpart of ``mvpnet_tpu/train/step.py::prepare_batch`` for inference:
dequantize the compact wire format and lift depth to world-space pixel
clouds on the device. Training (augmentation, the train step) is not ported
yet, and ``training=True`` raises.
"""
from __future__ import annotations

import torch

from mvpnet_torch.config import Config
from mvpnet_torch.core.camera import unproject_views


def prepare_batch(cfg: Config, batch: dict, *, training: bool) -> dict:
    """Lift depth to world-space pixel clouds.

    Input (tensors on one device): points (B,N,3), images (B,V,H,W,3),
    depth (B,V,H,W), poses (B,V,4,4), intrinsics (B,3,3), optional
    seg_label (B,N) and seg_label_2d (B,V,H,W). Compact dtypes are accepted:
    uint8 images (/255), uint16 millimeter depth, int16 millimeter points,
    int8 labels. Output: points, images, image_xyz (B,V,H,W,3), image_valid
    (B,V,H,W), and the labels (seg_label_2d set to the ignore label where the
    depth is invalid)."""
    if training:
        raise NotImplementedError("training-mode prepare_batch (augmentation) is not ported yet")
    images = batch["images"]
    depth = batch["depth"]
    if images.dtype == torch.uint8:
        images = images.float() / 255.0
    if depth.dtype == torch.uint16:
        depth = depth.float() / 1000.0
    points = batch["points"]
    if points.dtype == torch.int16:
        points = points.float() / 1000.0
    intr = batch["intrinsics"][:, None].expand(depth.shape[:2] + (3, 3))
    image_xyz, valid = unproject_views(depth, intr, batch["poses"])
    out = {
        "points": points,
        "images": images,
        "image_xyz": image_xyz,
        "image_valid": valid,
    }
    if "seg_label" in batch:  # absent in pure-inference batches (serving)
        out["seg_label"] = _labels(batch["seg_label"])
    if "seg_label_2d" in batch:
        # 2D supervision only on valid-depth pixels
        label = _labels(batch["seg_label_2d"])
        out["seg_label_2d"] = torch.where(valid, label, cfg.data.ignore_label)
    return out


def _labels(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32) if t.dtype == torch.int8 else t
