"""Training loop: build everything from cfg, iterate with periodic
validation, checkpointing and logging.

Counterpart of ``mvpnet_tpu/train/loop.py`` in one process on one device:
iteration-based loop, chunk-level validation with best-mIoU tracking,
auto-resume from the latest checkpoint, 2D warm start and freezing. The
JAX loop's data-parallel and space-sharded meshes and its torchvision
ResNet34 import raise ``NotImplementedError`` here (``ROADMAP.md`` Queue 1).
"""
from __future__ import annotations

import os
import time

import torch

from mvpnet_torch.config import Config, save_config
from mvpnet_torch.data.pipeline import PrefetchIterator, build_dataset
from mvpnet_torch.models.build import build_model
from mvpnet_torch.train.checkpoint import Checkpointer, trainable_parameters, warm_start_2d
from mvpnet_torch.train.metrics import iou_from_confusion
from mvpnet_torch.train.solver import build_optimizer
from mvpnet_torch.train.step import make_eval_step, make_train_step
from mvpnet_torch.utils.logger import MetricLogger, setup_logger
from mvpnet_torch.utils.writer import MetricWriter


def check_single_device(cfg: Config) -> None:
    """Raise on what the port does not run yet: meshes over several
    devices, and the torchvision ResNet34 import."""
    if cfg.mesh.space > 1 or cfg.mesh.data > 1:
        raise NotImplementedError(
            f"mesh data={cfg.mesh.data} space={cfg.mesh.space}: multi-GPU training is not ported yet "
            "(ROADMAP.md Queue 1, multi-GPU)"
        )
    if cfg.model.unet.torch_weights:
        raise NotImplementedError(
            "model.unet.torch_weights: the torchvision ResNet34 import is not ported yet "
            "(ROADMAP.md Queue 1, load_torch_resnet34)"
        )


def set_train_mode(model, cfg: Config) -> None:
    """Train mode; a frozen 2D net keeps its BN statistics (eval mode)."""
    model.train()
    if cfg.model.freeze_2d and hasattr(model, "net_2d"):
        model.net_2d.eval()


def evaluate(model, eval_step, val_iter, num_batches: int) -> dict:
    """Chunk-level validation: the confusion matrix summed on the device."""
    model.eval()
    cm = None
    losses = []
    for _ in range(num_batches):
        m = eval_step(model, next(val_iter))
        cm = m["confusion"] if cm is None else cm + m["confusion"]
        losses.append(m["loss"])
    iou, miou = iou_from_confusion(cm)
    return {"miou": float(miou), "loss": float(torch.stack(losses).mean()), "iou": iou.cpu().numpy()}


def train(cfg: Config, *, max_steps: int | None = None, resume: bool = True, device=None):
    """Run training; returns (model, final val metrics)."""
    from mvpnet_torch.entry import resolve_device

    check_single_device(cfg)
    dev = resolve_device(device)
    logger = setup_logger(output_dir=cfg.output_dir)
    save_config(cfg, f"{cfg.output_dir}/config.yaml")
    logger.info("device: %s", torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev)

    model, loss_fn, metric_fn = build_model(cfg, seed=cfg.train.seed)
    model = model.to(dev)
    if cfg.model.pretrained_2d and hasattr(model, "net_2d"):
        loaded = warm_start_2d(model, cfg.model.pretrained_2d)
        logger.info("2D warm-start from %s: %s", cfg.model.pretrained_2d, loaded)
    optimizer = build_optimizer(cfg.solver, trainable_parameters(model, cfg.model.freeze_2d))

    ckpt = Checkpointer(f"{cfg.output_dir}/checkpoints", keep=cfg.train.ckpt_keep)
    start_step = 0
    if resume:
        restored = ckpt.restore(model, optimizer)
        if restored is not None:
            start_step = restored + 1
            logger.info("resumed from step %d", restored)

    train_step = make_train_step(cfg, loss_fn, metric_fn)
    eval_step = make_eval_step(cfg, loss_fn, metric_fn)
    bs = cfg.train.batch_size
    train_ds = build_dataset(cfg.data, batch_size=bs, training=True, seed=cfg.train.seed)
    val_ds = build_dataset(cfg.data, batch_size=bs, training=False, seed=cfg.train.seed + 1000)
    pack = cfg.data.packed_transfer
    train_iter = PrefetchIterator(
        train_ds, prefetch=cfg.data.prefetch, num_threads=cfg.data.num_workers, device=dev, pack=pack
    )
    val_iter = PrefetchIterator(val_ds, prefetch=1, num_threads=2, device=dev, pack=pack)
    # augmentation draws (CPU); a resumed run continues from a fresh stream
    generator = torch.Generator().manual_seed(cfg.train.seed + start_step)

    meters = MetricLogger()
    writer = MetricWriter(cfg.output_dir)
    best_miou = -1.0
    total = max_steps if max_steps is not None else cfg.train.max_steps
    val_metrics: dict = {}
    set_train_mode(model, cfg)
    profiler = None
    t0 = time.perf_counter()
    try:
        for step in range(start_step, total):
            if cfg.train.profile_stop > cfg.train.profile_start:
                profiler = _profile_window(cfg, step, profiler)
            batch = next(train_iter)
            meters.tick("data_time")
            m = train_step(model, optimizer, batch, generator)
            meters.update(loss=m["loss"], accuracy=m["accuracy"])  # float(): waits for the step
            meters.tick("batch_time")

            if (step + 1) % cfg.train.log_every == 0 or step == start_step:
                chunks_s = bs / max(meters.meters["batch_time"].avg + meters.meters["data_time"].avg, 1e-9)
                logger.info("step %d/%d  %s  chunks/s: %.2f  lr: %.3g", step + 1, total, meters, chunks_s,
                            optimizer.schedule(step))
                writer.write(
                    step + 1,
                    {"loss": meters.meters["loss"].avg, "accuracy": meters.meters["accuracy"].avg,
                     "chunks_per_sec": chunks_s},
                    prefix="train/",
                )

            if (step + 1) % cfg.train.val_every == 0 or step + 1 == total:
                val_metrics = evaluate(model, eval_step, val_iter, cfg.train.val_steps)
                set_train_mode(model, cfg)
                logger.info("val @%d  loss: %.4f  mIoU: %.4f", step + 1, val_metrics["loss"], val_metrics["miou"])
                best_miou = max(best_miou, val_metrics["miou"])
                writer.write(step + 1, {"loss": val_metrics["loss"], "miou": val_metrics["miou"]}, prefix="val/")

            if (step + 1) % cfg.train.ckpt_every == 0 or step + 1 == total:
                ckpt.save(step, model, optimizer, metrics={"miou": val_metrics.get("miou", 0.0)})
    finally:
        if profiler is not None:
            profiler.stop()
        train_iter.close()
        val_iter.close()
        writer.close()
    wall = time.perf_counter() - t0
    steps_run = max(total - start_step, 1)
    logger.info("done: %d steps in %.1fs (%.2f chunks/s), best mIoU %.4f", steps_run, wall,
                steps_run * bs / wall, best_miou)
    return model, val_metrics


def _profile_window(cfg: Config, step: int, profiler):
    """torch.profiler over steps [profile_start, profile_stop); the trace goes
    to <output_dir>/profile/trace.json."""
    if step == cfg.train.profile_start:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=acts)
        profiler.start()
    elif step == cfg.train.profile_stop and profiler is not None:
        profiler.stop()
        os.makedirs(f"{cfg.output_dir}/profile", exist_ok=True)
        profiler.export_chrome_trace(f"{cfg.output_dir}/profile/trace.json")
        profiler = None
    return profiler
