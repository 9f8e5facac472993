"""Device-side batch preparation and the train and eval steps.

Counterpart of ``mvpnet_tpu/train/step.py``: the host ships raw arrays, and
everything geometric — dequantizing the compact wire format, lifting depth
to world-space pixel clouds, train-time augmentation — happens on the
device. Frame batches of 2D pretraining take ``prepare_frame_batch``. The fusion kNN runs inside ``MVPNet3D.forward``.

PyTorch runs eagerly, so the steps are plain functions over a model and an
optimizer (``train.solver.Optimizer``) that update them in place.

On a mesh (``dist.mesh``) each rank steps its local batch: augmentation
parameters are drawn for the global batch from the same generator on every
rank and each rank takes its data rank's rows, so every chunk gets the draw
that the one-process step gives it; the reported loss is the mean over the
ranks (``Mesh.world_mean``), and a space-sharded model's labels are cut to
the rank's share of the chunks (``dist.train_sp.local_share``).
"""
from __future__ import annotations

import torch

from mvpnet_torch import tracing
from mvpnet_torch.config import Config
from mvpnet_torch.core.augment import apply_chunk_augment, apply_frame_augment, sample_chunk_params, sample_frame_params
from mvpnet_torch.core.camera import unproject_views


def _rank_draw(sample, generator, rows: int, mesh, data) -> dict:
    """Augmentation parameters drawn by ``sample`` for the global batch
    (``rows`` a data rank) and this data rank's ``rows`` of them."""
    ranks, rank = (1, 0) if mesh is None else (mesh.data, mesh.data_rank)
    params = sample(generator, rows * ranks, flip_prob=data.flip_prob, jitter=data.color_jitter)
    return {k: v[rank * rows : (rank + 1) * rows] for k, v in params.items()}


def prepare_frame_batch(
    cfg: Config, batch: dict, *, training: bool, generator: torch.Generator | None = None, mesh=None
) -> dict:
    """Frame-mode preparation (2D pretraining on ``data/frames.py``
    batches: images (B,H,W,3), seg_label_2d (B,H,W)): dequantize uint8
    images (/255) and int8 labels, augment in training (``generator`` as in
    ``prepare_batch``), then add the views axis the 2D model and its loss
    expect, (B, 1, H, W, ...). No depth mask: every labeled pixel counts."""
    images = batch["images"]
    if images.dtype == torch.uint8:
        images = images.float() / 255.0
    label = _labels(batch["seg_label_2d"])
    if training and cfg.data.augment and generator is not None:
        d = cfg.data
        params = _rank_draw(sample_frame_params, generator, images.shape[0], mesh, d)
        images, label = apply_frame_augment(images, label, params, flip_prob=d.flip_prob, jitter=d.color_jitter)
    return {"images": images[:, None], "seg_label_2d": label[:, None]}


def prepare_batch(
    cfg: Config, batch: dict, *, training: bool, generator: torch.Generator | None = None, mesh=None
) -> dict:
    """Lift depth to world-space pixel clouds; augment in training.

    Input (tensors on one device): points (B,N,3), images (B,V,H,W,3),
    depth (B,V,H,W), poses (B,V,4,4), intrinsics (B,3,3), optional
    seg_label (B,N) and seg_label_2d (B,V,H,W). Compact dtypes are accepted:
    uint8 images (/255), uint16 millimeter depth, int16 millimeter points,
    int8 labels. Output: points, images, image_xyz (B,V,H,W,3), image_valid
    (B,V,H,W), and the labels (seg_label_2d set to the ignore label where the
    depth is invalid). Optional per-point colors (B,N,3), for the xyz+RGB
    baseline, pass through (uint8 /255).

    A batch without ``depth`` is a frame batch and goes to
    ``prepare_frame_batch``.

    With ``training``, ``cfg.data.augment`` and a ``generator`` (a CPU
    ``torch.Generator``), each sample's augmentation parameters are drawn
    from it and applied to points, image_xyz and images
    (``core/augment.py``); with a ``mesh`` they are drawn for the global
    batch and this data rank's rows applied."""
    if "depth" not in batch:
        return prepare_frame_batch(cfg, batch, training=training, generator=generator, mesh=mesh)
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
    if training and cfg.data.augment and generator is not None:
        d = cfg.data
        params = _rank_draw(sample_chunk_params, generator, points.shape[0], mesh, d)
        points, image_xyz, images = apply_chunk_augment(
            points, image_xyz, images, params, z_rot=d.z_rot, flip_prob=d.flip_prob, jitter=d.color_jitter
        )
    out = {
        "points": points,
        "images": images,
        "image_xyz": image_xyz,
        "image_valid": valid,
    }
    if "seg_label" in batch:  # absent in pure-inference batches (serving)
        out["seg_label"] = _labels(batch["seg_label"])
    if "colors" in batch:  # per-point RGB of the xyz+RGB baseline (models/build.PN2Seg)
        colors = batch["colors"]
        out["colors"] = colors.float() / 255.0 if colors.dtype == torch.uint8 else colors
    if "seg_label_2d" in batch:
        # 2D supervision only on valid-depth pixels
        label = _labels(batch["seg_label_2d"])
        out["seg_label_2d"] = torch.where(valid, label, cfg.data.ignore_label)
    return out


def _labels(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32) if t.dtype == torch.int8 else t


def _model_batch(cfg: Config, model, batch: dict, *, training: bool, generator=None, mesh=None) -> dict:
    """``prepare_batch``, with the 3D labels cut to this rank's share when
    the model (or the model DDP wraps) fuses over a space group."""
    out = prepare_batch(cfg, batch, training=training, generator=generator, mesh=mesh)
    fusion_mesh = getattr(getattr(model, "module", model), "fusion_mesh", None)
    if fusion_mesh is not None and fusion_mesh.space > 1 and "seg_label" in out:
        from mvpnet_torch.dist.train_sp import local_share

        out["seg_label"] = local_share(fusion_mesh, out["seg_label"])
    return out


def _report(loss: torch.Tensor, mesh) -> torch.Tensor:
    return loss.detach() if mesh is None else mesh.world_mean(loss.detach())


def make_train_step(cfg: Config, loss_fn, metric_fn, mesh=None):
    """The training step: ``train_step(model, optimizer, batch, generator)
    -> metrics`` (device tensors: loss, accuracy, confusion).

    The model must be in train mode. With ``cfg.train.grad_accum = n > 1``
    the batch is split into n sequential microbatches: their gradients are
    summed and divided by n, and the optimizer makes one update (the JAX
    step's ``lax.scan``, ``mvpnet_tpu/train/step.py:141-179``). The confusion
    matrix is summed over microbatches, the other metrics averaged; BN batch
    statistics see microbatches and move once per microbatch.

    On a ``mesh`` the model is the rank's (DDP-wrapped when ranks share
    gradients), ``loss_fn`` and ``metric_fn`` those of
    ``loss_and_metrics(cfg, mesh)``; microbatches split each rank's local
    batch.

    Spans (``tracing``): ``train.step``, and below it ``train.prepare``,
    ``train.forward`` (the model, the loss and the metrics) and
    ``train.backward`` for each microbatch, then ``train.optimizer``."""
    accum = max(1, int(cfg.train.grad_accum))

    def micro_step(model, batch, generator):
        with tracing.span("train.prepare"):
            model_batch = _model_batch(cfg, model, batch, training=True, generator=generator, mesh=mesh)
        with tracing.span("train.forward"):
            out = model(model_batch)
            loss = loss_fn(out, model_batch)
            with torch.no_grad():
                metrics = metric_fn(out, model_batch)
        with tracing.span("train.backward"):
            loss.backward()
        metrics["loss"] = _report(loss, mesh)
        return metrics

    def train_step(model, optimizer, batch: dict, generator: torch.Generator | None = None) -> dict:
        with tracing.span("train.step"):
            return _train_step(model, optimizer, batch, generator)

    def _train_step(model, optimizer, batch, generator):
        optimizer.zero_grad()
        if accum == 1:
            metrics = micro_step(model, batch, generator)
            with tracing.span("train.optimizer"):
                optimizer.step()
            return metrics
        B = next(iter(batch.values())).shape[0]
        if B % accum:
            raise ValueError(f"batch {B} not divisible by grad_accum={accum}")
        size = B // accum
        stack: dict = {}
        for a in range(accum):
            micro = {k: v[a * size : (a + 1) * size] for k, v in batch.items()}
            for k, v in micro_step(model, micro, generator).items():
                stack.setdefault(k, []).append(v)
        with tracing.span("train.optimizer"):
            with torch.no_grad():
                for p in optimizer.params:
                    if p.grad is not None:
                        p.grad.div_(accum)
            optimizer.step()
        # counts (the confusion matrix) add up; rates and losses average
        return {
            k: torch.stack(v).sum(0) if k == "confusion" else torch.stack(v).float().mean(0)
            for k, v in stack.items()
        }

    return train_step


def make_eval_step(cfg: Config, loss_fn, metric_fn, mesh=None):
    """``eval_step(model, batch) -> metrics`` without gradients; the caller
    puts the model in eval mode. On a ``mesh`` the loss is the mean over the
    ranks and the metrics are global, as in ``make_train_step``."""

    @torch.no_grad()
    def eval_step(model, batch: dict) -> dict:
        model_batch = _model_batch(cfg, model, batch, training=False)
        out = model(model_batch)
        metrics = metric_fn(out, model_batch)
        metrics["loss"] = _report(loss_fn(out, model_batch), mesh)
        return metrics

    return eval_step
