"""Model registry: build_model(cfg) -> (model, loss_fn, metric_fn).

Counterpart of ``mvpnet_tpu/models/build.py``: the fusion model
``mvpnet_3d``, the 2D pretraining model ``sem_seg_2d`` and the PointNet++
baseline ``pn2ssg`` (xyz only or xyz + RGB). Each model's attribute names
match the JAX package's, so ``convert.load_jax_params`` carries weights
across, and a ``sem_seg_2d`` checkpoint's ``net_2d`` warm-starts
``MVPNet3D.net_2d``.
"""
from __future__ import annotations

import torch
from torch import nn

from mvpnet_torch.config import Config, ModelConfig
from mvpnet_torch.models.fusion import MVPNet3D
from mvpnet_torch.models.pointnet2 import PN2SSG
from mvpnet_torch.models.unet import UNetResNet34
from mvpnet_torch.train import metrics as M

MODELS = ("mvpnet_3d", "sem_seg_2d", "pn2ssg")


class PN2Seg(nn.Module):
    """PointNet++ baseline: chunk batch -> (logits, None).

    xyz only (``pn2.in_channels == 0``) or xyz + per-point RGB
    (``in_channels == 3``, which needs ``data.include_colors=true`` so the
    pipeline ships colors and ``prepare_batch`` forwards them). Returns
    ``(logits_3d, None)`` so the train and eval steps and whole-scene
    evaluation unpack it as MVPNet3D's ``(logits_3d, logits_2d)``."""

    def __init__(self, cfg: ModelConfig, *, gen: torch.Generator):
        super().__init__()
        if cfg.pn2.in_channels not in (0, 3):
            raise ValueError(
                "model.name=pn2ssg supports pn2.in_channels 0 (xyz-only) or "
                f"3 (xyz+RGB), got {cfg.pn2.in_channels}"
            )
        self.in_channels = cfg.pn2.in_channels
        self.net_3d = PN2SSG(cfg.pn2, gen=gen)

    def forward(self, batch):
        features = None
        if self.in_channels == 3:
            if "colors" not in batch:
                raise KeyError("pn2ssg with pn2.in_channels=3 consumes per-point RGB: set data.include_colors=true")
            features = batch["colors"]
        return self.net_3d(batch["points"], features), None


class SemSeg2D(nn.Module):
    """2D pretraining model: batch with images (B, V, H, W, 3) -> per-view
    (features, logits), each (B, V, H, W, C). The UNet is ``net_2d``, so a
    checkpoint of this model lines up with ``MVPNet3D.net_2d``."""

    def __init__(self, cfg: ModelConfig, *, gen: torch.Generator):
        super().__init__()
        self.net_2d = UNetResNet34(cfg.unet, gen=gen)

    def forward(self, batch):
        images = batch["images"]
        B, V, H, W, _ = images.shape
        feat, logits = self.net_2d(images.reshape(B * V, H, W, 3))
        return feat.reshape(B, V, H, W, -1), logits.reshape(B, V, H, W, -1)


def build_model(cfg: Config, *, seed: int = 0):
    """Returns (model, loss_fn(model_out, batch) -> scalar,
    metric_fn(model_out, batch) -> dict). Weights are drawn on the CPU from
    a ``torch.Generator`` seeded with ``seed``. The model comes in train mode,
    as a fresh module does (and the JAX package's): the caller sets
    ``.eval()`` for inference. For ``mvpnet_3d``, ``cfg.train.remat`` sets
    ``remat_2d``."""
    name = cfg.model.name
    if name not in MODELS:
        raise ValueError(f"unknown model {name!r}")
    gen = torch.Generator().manual_seed(seed)
    if name == "mvpnet_3d":
        model = MVPNet3D(cfg.model, gen=gen)
        model.remat_2d = cfg.train.remat
    elif name == "sem_seg_2d":
        model = SemSeg2D(cfg.model, gen=gen)
    else:
        model = PN2Seg(cfg.model, gen=gen)
    return (model, *loss_and_metrics(cfg))


def loss_and_metrics(cfg: Config, mesh=None):
    """(loss_fn, metric_fn) of ``cfg.model.name``: cross-entropy, accuracy
    and the confusion matrix of the 3D logits (``mvpnet_3d``, ``pn2ssg``) or
    of the per-view 2D logits against ``seg_label_2d`` (``sem_seg_2d``);
    ``mvpnet_3d`` adds ``aux_2d_loss_weight`` times the 2D logits'
    cross-entropy. With a ``mesh`` that syncs, each term is global over the
    ranks (``train/metrics.py``)."""
    ignore = cfg.data.ignore_label
    aux_w = cfg.model.aux_2d_loss_weight if cfg.model.name == "mvpnet_3d" else 0.0
    if cfg.model.name == "sem_seg_2d":
        def logits_and_label(out, batch):
            return out[1], batch["seg_label_2d"]
    else:
        def logits_and_label(out, batch):
            return out[0], batch["seg_label"]

    def loss_fn(out, batch):
        logits, label = logits_and_label(out, batch)
        loss = M.cross_entropy(logits, label, ignore, mesh)
        if aux_w > 0 and "seg_label_2d" in batch:
            loss = loss + aux_w * M.cross_entropy(out[1], batch["seg_label_2d"], ignore, mesh)
        return loss

    def metric_fn(out, batch):
        logits, label = logits_and_label(out, batch)
        return {
            "accuracy": M.seg_accuracy(logits, label, ignore, mesh),
            "confusion": M.confusion_matrix(logits, label, cfg.data.num_classes, ignore, mesh),
        }

    return loss_fn, metric_fn
