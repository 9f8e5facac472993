"""Inference entry point of the port: the counterpart of
``__graft_entry__.entry()``.

``entry(device=None)`` builds the flagship MVPNet3D at the default
``Config()`` (full width, bf16 compute, B=1, N=8192, V=5 views of 120x160)
with seeded random weights and returns ``(forward, (model, batch))``:
``forward(model, batch)`` answers one request — ``prepare_batch`` then the
model — and returns the 3D logits (B, N, num_classes) f32. ``batch`` is the
numpy-seeded example batch of ``__graft_entry__._example_batch``.

It runs on CUDA unless the caller passes ``device="cpu"``; with no CUDA and
no explicit device it raises.
"""
from __future__ import annotations

import numpy as np
import torch

from mvpnet_torch.config import Config
from mvpnet_torch.models.build import build_model
from mvpnet_torch.train.step import prepare_batch


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
