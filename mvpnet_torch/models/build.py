"""Model registry: build_model(cfg) -> (model, loss_fn, metric_fn).

Counterpart of ``mvpnet_tpu/models/build.py`` for ``mvpnet_3d``; the 2D
pretraining and PointNet++ baseline models are not ported yet.
"""
from __future__ import annotations

import torch

from mvpnet_torch.config import Config
from mvpnet_torch.models.fusion import MVPNet3D
from mvpnet_torch.train import metrics as M


def build_model(cfg: Config, *, seed: int = 0):
    """Returns (model, loss_fn(model_out, batch) -> scalar,
    metric_fn(model_out, batch) -> dict). Weights are drawn on the CPU from
    a ``torch.Generator`` seeded with ``seed``. The model comes in train mode,
    as a fresh module does (and the JAX package's): the caller sets
    ``.eval()`` for inference. ``cfg.train.remat`` sets ``remat_2d``."""
    name = cfg.model.name
    if name != "mvpnet_3d":
        raise NotImplementedError(f"model {name!r} is not ported yet (only 'mvpnet_3d')")
    gen = torch.Generator().manual_seed(seed)
    model = MVPNet3D(cfg.model, gen=gen)
    model.remat_2d = cfg.train.remat
    return (model, *loss_and_metrics(cfg))


def loss_and_metrics(cfg: Config):
    """(loss_fn, metric_fn) of ``mvpnet_3d``: cross-entropy over the 3D
    logits plus ``aux_2d_loss_weight`` times that of the 2D logits; accuracy
    and the confusion matrix of the 3D logits."""
    ignore = cfg.data.ignore_label
    aux_w = cfg.model.aux_2d_loss_weight

    def loss_fn(out, batch):
        logits_3d, logits_2d = out
        loss = M.cross_entropy(logits_3d, batch["seg_label"], ignore)
        if aux_w > 0 and "seg_label_2d" in batch:
            loss = loss + aux_w * M.cross_entropy(logits_2d, batch["seg_label_2d"], ignore)
        return loss

    def metric_fn(out, batch):
        logits_3d, _ = out
        return {
            "accuracy": M.seg_accuracy(logits_3d, batch["seg_label"], ignore),
            "confusion": M.confusion_matrix(logits_3d, batch["seg_label"], cfg.data.num_classes, ignore),
        }

    return loss_fn, metric_fn
