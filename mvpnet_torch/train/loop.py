"""Training loop: build everything from cfg, iterate with periodic
validation, checkpointing and logging.

Counterpart of ``mvpnet_tpu/train/loop.py`` for every model of
``models/build.py`` (``sem_seg_2d`` on frame batches, ``mvpnet_3d`` and
``pn2ssg`` on chunks): iteration-based loop, validation with best-mIoU
tracking, auto-resume from the latest checkpoint, the torchvision ResNet34
encoder import, 2D warm start and freezing.

Under a launcher (``python -m torch.distributed.run``; ``dist/bootstrap.py``)
each process is one rank of the ``cfg.mesh`` mesh: data-parallel over
``mesh.data`` (DDP on its own group; ``freeze_2d``'s parameters stay out of
it), space-sharded when ``mesh.space > 1`` and the model fuses views
(``dist/train_sp.py``). BatchNorm, the loss and the metrics are global over
the ranks; each data rank loads its slice of the global batch with its own
seed; only rank 0 writes the config, the log file, the metrics and the
checkpoints, and every rank waits for it before a resume. Without a
launcher it is one process on one device, as before.

``train.deterministic`` turns on ``set_deterministic`` for the rest of the
process: two runs of one config on one card then give equal losses bit for
bit, at some cost in speed (``PERF.md``).
"""
from __future__ import annotations

import os
import time

import torch

from mvpnet_torch import ops
from mvpnet_torch.config import Config, save_config
from mvpnet_torch.data.pipeline import PrefetchIterator, build_dataset
from mvpnet_torch.dist import bootstrap
from mvpnet_torch.dist import mesh as mesh_mod
from mvpnet_torch.models.build import build_model, loss_and_metrics
from mvpnet_torch.train.checkpoint import Checkpointer, trainable_parameters, warm_start_2d
from mvpnet_torch.train.metrics import iou_from_confusion
from mvpnet_torch.train.solver import build_optimizer
from mvpnet_torch.train.step import make_eval_step, make_train_step
from mvpnet_torch.utils.logger import MetricLogger, setup_logger
from mvpnet_torch.utils.writer import MetricWriter


# the cuBLAS workspace settings under which torch lets cuBLAS run in the
# deterministic mode (the first is the one the docs name)
CUBLAS_WORKSPACE_CONFIGS = (":4096:8", ":16:8")


def set_deterministic(enabled: bool = True, device=None) -> None:
    """The deterministic mode (``train.deterministic``): every op takes a
    deterministic algorithm or raises (``torch.use_deterministic_algorithms``,
    never only a warning), cuDNN picks deterministic algorithms and does not
    benchmark, and the UNet's resize takes its deterministic backward
    (``models/unet.py``). On CUDA (``device``, else whenever CUDA is
    available) cuBLAS needs ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` in the
    environment before its first call; without it this raises.
    ``enabled=False`` restores the default mode. Process-wide."""
    cuda = torch.cuda.is_available() if device is None else torch.device(device).type == "cuda"
    if enabled and cuda and os.environ.get("CUBLAS_WORKSPACE_CONFIG") not in CUBLAS_WORKSPACE_CONFIGS:
        raise RuntimeError(
            "the deterministic mode on CUDA needs CUBLAS_WORKSPACE_CONFIG=:4096:8 in the environment "
            f"(set before the process's first cuBLAS call), got {os.environ.get('CUBLAS_WORKSPACE_CONFIG')!r}"
        )
    torch.use_deterministic_algorithms(enabled, warn_only=False)
    torch.backends.cudnn.deterministic = enabled
    torch.backends.cudnn.benchmark = False


def set_train_mode(model, cfg: Config) -> None:
    """Train mode; a frozen 2D net keeps its BN statistics (eval mode)."""
    model.train()
    if cfg.model.freeze_2d and hasattr(model, "net_2d"):
        model.net_2d.eval()


def evaluate(model, eval_step, val_iter, num_batches: int) -> dict:
    """Chunk-level validation: the confusion matrix summed on the device
    (over every rank with a mesh's eval step)."""
    model.eval()
    cm = None
    losses = []
    for _ in range(num_batches):
        m = eval_step(model, next(val_iter))
        cm = m["confusion"] if cm is None else cm + m["confusion"]
        losses.append(m["loss"])
    iou, miou = iou_from_confusion(cm)
    return {"miou": float(miou), "loss": float(torch.stack(losses).mean()), "iou": iou.cpu().numpy()}


def distribute(model, mesh, dev):
    """Put a model on a process mesh: BN statistics over the mesh and
    Dropout masks drawn for the global batch (``dist.mesh.install``), the
    ring fusion when the mesh has a space axis and the model fuses views
    (``install_space_fusion``), and DDP over the mesh's own DDP group.
    Parameters that do not require gradients (``freeze_2d``) stay out of
    DDP; BN's running statistics are equal on every rank, so DDP broadcasts
    no buffers.

    Returns (the DDP model the train step runs, the batch specs of
    ``bootstrap.make_global_batch``: ``train_sp.batch_specs`` when
    space-sharded, else None)."""
    mesh_mod.install(model, mesh)
    specs = None
    if mesh.space > 1 and hasattr(model, "aggregation"):
        from mvpnet_torch.dist.train_sp import batch_specs, install_space_fusion

        install_space_fusion(model, mesh)
        specs = batch_specs
    ddp = torch.nn.parallel.DistributedDataParallel(
        model,
        device_ids=[dev.index] if dev.type == "cuda" else None,
        process_group=mesh.ddp_group,
        broadcast_buffers=False,
    )
    return ddp, specs


def train(cfg: Config, *, max_steps: int | None = None, resume: bool = True, device=None):
    """Run training; returns (model, final val metrics)."""
    from mvpnet_torch.entry import resolve_device, to_device

    bootstrap.initialize(device=device)  # no launcher: no group, one process
    dev = bootstrap.device() or resolve_device(device)
    if cfg.train.deterministic:
        set_deterministic(device=dev)
    mesh = mesh_mod.make_mesh(cfg.mesh)
    grouped = mesh.ddp_group is not None
    primary = bootstrap.is_primary()
    logger = setup_logger(output_dir=cfg.output_dir if primary else None)
    if primary:
        save_config(cfg, f"{cfg.output_dir}/config.yaml")
    logger.info("device: %s", torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev)
    if grouped:
        logger.info("%s; mesh %s, data rank %d, space rank %d", bootstrap.describe(), mesh.shape,
                    mesh.data_rank, mesh.space_rank)

    model, _, _ = build_model(cfg, seed=cfg.train.seed)
    if cfg.model.unet.torch_weights and hasattr(model, "net_2d"):
        from mvpnet_torch.models.unet import load_torch_resnet34_file

        keys = load_torch_resnet34_file(model.net_2d.encoder, cfg.model.unet.torch_weights)
        logger.info("imported torchvision resnet34 encoder from %s (%d keys)", cfg.model.unet.torch_weights, len(keys))
    model = model.to(dev)
    if cfg.model.pretrained_2d and hasattr(model, "net_2d"):
        loaded = warm_start_2d(model, cfg.model.pretrained_2d)
        logger.info("2D warm-start from %s: %s", cfg.model.pretrained_2d, loaded)
    optimizer = build_optimizer(cfg.solver, trainable_parameters(model, cfg.model.freeze_2d))
    step_model, step_mesh, specs = model, None, None
    if grouped:
        step_model, specs = distribute(model, mesh, dev)
        step_mesh = mesh
        if specs is not None:
            logger.info("space-sharded training enabled (space=%d)", mesh.space)
    loss_fn, metric_fn = loss_and_metrics(cfg, step_mesh)

    ckpt = Checkpointer(f"{cfg.output_dir}/checkpoints", keep=cfg.train.ckpt_keep)
    start_step = 0
    if resume:
        bootstrap.barrier()  # the primary's checkpoints are complete
        restored = ckpt.restore(model, optimizer)
        if restored is not None:
            start_step = restored + 1
            logger.info("resumed from step %d", restored)

    train_step = make_train_step(cfg, loss_fn, metric_fn, step_mesh)
    eval_step = make_eval_step(cfg, loss_fn, metric_fn, step_mesh)
    bs = cfg.train.batch_size
    local_bs = bootstrap.global_batch_to_local(bs, mesh)
    # each data rank loads its own slice of the global batch; the ranks of
    # one space group load the same chunks
    train_ds = build_dataset(cfg.data, batch_size=local_bs, training=True, seed=cfg.train.seed + mesh.data_rank)
    val_ds = build_dataset(cfg.data, batch_size=local_bs, training=False, seed=cfg.train.seed + 1000 + mesh.data_rank)
    pack = cfg.data.packed_transfer
    put_fn = None
    if grouped:
        def put_fn(batch):
            local = bootstrap.make_global_batch(mesh, batch, specs(batch) if specs else None)
            return to_device(local, dev)

    train_iter = PrefetchIterator(
        train_ds, prefetch=cfg.data.prefetch, num_threads=cfg.data.num_workers, device=dev, pack=pack, put_fn=put_fn
    )
    val_iter = PrefetchIterator(val_ds, prefetch=1, num_threads=2, device=dev, pack=pack, put_fn=put_fn)
    # augmentation draws (CPU); a resumed run continues from a fresh stream
    generator = torch.Generator().manual_seed(cfg.train.seed + start_step)

    meters = MetricLogger()
    writer = MetricWriter(cfg.output_dir) if primary else None
    best_miou = -1.0
    total = max_steps if max_steps is not None else cfg.train.max_steps
    val_metrics: dict = {}
    set_train_mode(model, cfg)
    profiler = None
    t0 = time.perf_counter()
    try:
        for step in range(start_step, total):
            if primary and cfg.train.profile_stop > cfg.train.profile_start:
                profiler = _profile_window(cfg, step, profiler)
            batch = next(train_iter)
            meters.tick("data_time")
            m = train_step(step_model, optimizer, batch, generator)
            meters.update(loss=m["loss"], accuracy=m["accuracy"])  # float(): waits for the step
            meters.tick("batch_time")

            if (step + 1) % cfg.train.log_every == 0 or step == start_step:
                chunks_s = bs / max(meters.meters["batch_time"].avg + meters.meters["data_time"].avg, 1e-9)
                logger.info("step %d/%d  %s  chunks/s: %.2f  lr: %.3g", step + 1, total, meters, chunks_s,
                            optimizer.schedule(step))
                if writer:
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
                if writer:
                    writer.write(step + 1, {"loss": val_metrics["loss"], "miou": val_metrics["miou"]}, prefix="val/")

            if primary and ((step + 1) % cfg.train.ckpt_every == 0 or step + 1 == total):
                ckpt.save(step, model, optimizer, metrics={"miou": val_metrics.get("miou", 0.0)})
    finally:
        if profiler is not None:
            profiler.stop()
        train_iter.close()
        val_iter.close()
        if writer:
            writer.close()
    wall = time.perf_counter() - t0
    steps_run = max(total - start_step, 1)
    logger.info("done: %d steps in %.1fs (%.2f chunks/s), best mIoU %.4f", steps_run, wall,
                steps_run * bs / wall, best_miou)
    logger.info("kernel launches since start: %s", ops.launch_counts())
    return model, val_metrics


def _profile_window(cfg: Config, step: int, profiler):
    """torch.profiler over steps [profile_start, profile_stop), which also
    turns the port's spans on (``tracing``); the trace goes to
    <output_dir>/profile/trace.json."""
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
