"""Losses and metrics.

Counterpart of ``mvpnet_tpu/train/metrics.py``: cross-entropy with an ignore
label, accuracy, and the confusion matrix accumulated with one bincount
over ``num_classes * label + pred``.

Given a mesh that syncs (``dist.mesh``), each is global over the ranks, as
JAX's are over its global batch: the counts are all-reduced, and
``cross_entropy`` returns this rank's share of the global mean times the
world size, so that DDP's average of the gradients is the gradient of the
global mean (``Mesh.world_mean`` of the returned values is that mean).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _syncs(mesh) -> bool:
    return mesh is not None and mesh.syncs


def cross_entropy(logits, labels, ignore_label: int = -100, mesh=None):
    """Mean softmax cross-entropy over non-ignored elements (0 when none);
    with a mesh that syncs, this rank's share of the global mean times the
    world size."""
    valid = labels != ignore_label
    safe = torch.where(valid, labels, 0).long()
    losses = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]), safe.reshape(-1), reduction="none")
    losses = torch.where(valid.reshape(-1), losses, 0.0)
    if not _syncs(mesh):
        return losses.sum() / valid.sum().clamp(min=1)
    return losses.sum() * mesh.world / mesh.all_sum(valid.sum()).clamp(min=1)


def seg_accuracy(logits, labels, ignore_label: int = -100, mesh=None):
    """Fraction of non-ignored elements predicted correctly (over every
    rank with a mesh that syncs)."""
    valid = labels != ignore_label
    correct = (logits.argmax(-1) == labels) & valid
    if not _syncs(mesh):
        return correct.sum() / valid.sum().clamp(min=1)
    counts = mesh.all_sum(torch.stack([correct.sum(), valid.sum()]))
    return counts[0] / counts[1].clamp(min=1)


def confusion_matrix(logits_or_pred, labels, num_classes: int, ignore_label: int = -100, mesh=None):
    """(num_classes, num_classes) counts, rows = true labels; accepts logits
    (..., C) or integer predictions (...); summed over every rank with a
    mesh that syncs."""
    if logits_or_pred.ndim == labels.ndim + 1:
        pred = logits_or_pred.argmax(-1)
    else:
        pred = logits_or_pred
    valid = labels != ignore_label
    idx = torch.where(valid, labels.long() * num_classes + pred.long(), num_classes * num_classes)
    counts = torch.bincount(idx.reshape(-1), minlength=num_classes * num_classes + 1)
    cm = counts[:-1].reshape(num_classes, num_classes)
    return mesh.all_sum(cm) if _syncs(mesh) else cm


def iou_from_confusion(cm):
    """Per-class IoU + mIoU over classes present in GT or prediction."""
    cm = cm.double()
    tp = torch.diagonal(cm)
    denom = cm.sum(0) + cm.sum(1) - tp
    iou = tp / denom.clamp(min=1)
    present = denom > 0
    miou = torch.where(present, iou, 0.0).sum() / present.sum().clamp(min=1)
    return iou, miou
