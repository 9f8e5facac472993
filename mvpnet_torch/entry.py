"""Inference entry points of the port.

``entry`` is the counterpart of ``__graft_entry__.entry()``, the chunk
request path; ``scene_entry`` builds the whole-scene evaluator from a YAML
config, by default the high-resolution config (BASELINE.json config #4).

``entry(device=None)`` builds the flagship MVPNet3D at the default
``Config()`` (full width, bf16 compute, B=1, N=8192, V=5 views of 120x160)
with seeded random weights and returns ``(forward, (model, batch))``:
``forward(model, batch)`` answers one request — ``prepare_batch`` then the
model — and returns the 3D logits (B, N, num_classes) f32. ``batch`` is the
numpy-seeded example batch of ``__graft_entry__._example_batch``.

``train_entry`` builds the training path of any model: by default the
training config (``configs/scannet/mvpnet_3d_unet_resnet34_pn2ssg.yaml`` on
synthetic scenes); with ``cfg`` at ``sem_seg_2d_unet_resnet34.yaml``
(``data.sampling=frames``) the 2D pretraining path, at ``pn2ssg_xyz.yaml`` or
``pn2ssg_rgb.yaml`` the PointNet++ baselines.

All run on CUDA unless the caller passes ``device="cpu"``; with no CUDA and
no explicit device they raise.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch

from mvpnet_torch.config import Config, load_config
from mvpnet_torch.models.build import build_model
from mvpnet_torch.train.step import prepare_batch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIGHRES_CONFIG = os.path.join(_ROOT, "configs", "scannet", "mvpnet_3d_highres_64view.yaml")
TRAIN_CONFIG = os.path.join(_ROOT, "configs", "scannet", "mvpnet_3d_unet_resnet34_pn2ssg.yaml")
# ScanNet is not in the repository: the training config runs on synthetic
# scenes, from random weights
TRAIN_OVERRIDES = ["data.name=synthetic"]


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else CUDA; raises when CUDA is absent and the
    caller did not ask for the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("mvpnet_torch runs on CUDA; no CUDA device found (pass device='cpu' to run on the CPU)")
    return torch.device("cuda")


def example_batch(rng: np.random.Generator, B, N, V, H, W, num_classes=20) -> dict:
    """Numpy batch of ``__graft_entry__._example_batch``, same draws in the
    same order."""
    poses = np.tile(np.eye(4, dtype=np.float32), (B, V, 1, 1))
    poses[..., :3, 3] = rng.uniform(-1, 1, (B, V, 3))
    fx = 0.6 * W
    intr = np.array([[fx, 0, W / 2], [0, fx, H / 2], [0, 0, 1]], np.float32)
    return {
        "points": rng.uniform(-2, 2, (B, N, 3)).astype(np.float32),
        "seg_label": rng.integers(0, num_classes, (B, N)).astype(np.int32),
        "images": rng.uniform(size=(B, V, H, W, 3)).astype(np.float32),
        "depth": rng.uniform(0.5, 4.0, (B, V, H, W)).astype(np.float32),
        "poses": poses,
        "intrinsics": np.tile(intr, (B, 1, 1)),
        "seg_label_2d": rng.integers(0, num_classes, (B, V, H, W)).astype(np.int32),
    }


def to_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def entry(device=None, cfg: Config | None = None, seed: int = 0):
    """(forward, (model, batch)) for the default config; see the module doc."""
    dev = resolve_device(device)
    cfg = cfg or Config()
    model, _, _ = build_model(cfg, seed=seed)
    model = model.to(dev).eval()

    @torch.no_grad()
    def forward(model, batch):
        batch = to_device(batch, dev)
        logits_3d, _ = model(prepare_batch(cfg, batch, training=False))
        return logits_3d

    batch = example_batch(
        np.random.default_rng(seed),
        B=1,
        N=cfg.data.num_points,
        V=cfg.data.num_views_eval,
        H=cfg.data.image_height,
        W=cfg.data.image_width,
    )
    return forward, (model, batch)


def scene_entry(device=None, cfg_path: str = HIGHRES_CONFIG, seed: int = 0):
    """(evaluate, (model, cfg)) for whole-scene evaluation.

    The config is the YAML file ``cfg_path`` (``load_config``); the model has
    seeded random weights, on ``device``.
    ``evaluate(scenes, fused=False, export_dir=None)`` runs
    ``eval.whole_scene.evaluate_scenes`` with ``cfg.eval.batch_size`` chunk
    windows per forward and returns its results (mIoU, accuracy, per-class
    IoU)."""
    from mvpnet_torch.eval.whole_scene import evaluate_scenes

    dev = resolve_device(device)
    cfg = load_config(cfg_path)
    model, _, _ = build_model(cfg, seed=seed)
    model = model.to(dev).eval()
    evaluate = functools.partial(evaluate_scenes, model, cfg, batch_size=cfg.eval.batch_size)
    return evaluate, (model, cfg)


def train_entry(device=None, cfg: Config | None = None, seed: int = 0):
    """(step, (model, optimizer, batches)) for the training path.

    ``cfg`` defaults to the training config on synthetic scenes (full width,
    bf16 compute, B=8, N=8192, V=3 views of 120x160); any other model of
    ``build_model`` (``sem_seg_2d`` on frame batches, ``pn2ssg`` on chunks)
    runs the same way. The model has seeded random weights, in train mode,
    on ``device``. ``batches`` is the
    ``PrefetchIterator`` over the config's training set (``close()`` it).
    ``step()`` takes the next batch and runs one ``make_train_step`` step
    (augmentation drawn from a generator seeded with ``seed``) and returns
    its metrics; ``step(batch)`` runs it on a given device batch."""
    from mvpnet_torch.data.pipeline import PrefetchIterator, build_dataset
    from mvpnet_torch.train.checkpoint import trainable_parameters
    from mvpnet_torch.train.loop import check_single_device, set_train_mode
    from mvpnet_torch.train.solver import build_optimizer
    from mvpnet_torch.train.step import make_train_step

    dev = resolve_device(device)
    cfg = cfg or load_config(TRAIN_CONFIG, TRAIN_OVERRIDES)
    check_single_device(cfg)
    model, loss_fn, metric_fn = build_model(cfg, seed=seed)
    model = model.to(dev)
    set_train_mode(model, cfg)
    optimizer = build_optimizer(cfg.solver, trainable_parameters(model, cfg.model.freeze_2d))
    train_step = make_train_step(cfg, loss_fn, metric_fn)
    data = build_dataset(cfg.data, batch_size=cfg.train.batch_size, training=True, seed=seed)
    batches = PrefetchIterator(
        data, prefetch=cfg.data.prefetch, num_threads=cfg.data.num_workers, device=dev, pack=cfg.data.packed_transfer
    )
    generator = torch.Generator().manual_seed(seed)

    def step(batch: dict | None = None) -> dict:
        return train_step(model, optimizer, next(batches) if batch is None else batch, generator)

    return step, (model, optimizer, batches)
