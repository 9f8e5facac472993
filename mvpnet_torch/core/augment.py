"""Train-time augmentation of chunk batches, on the device.

Counterpart of ``mvpnet_tpu/core/augment.py::augment_chunk``: a shared random
z-rotation and x/y flips of the chunk points and the unprojected pixel
clouds (both live in world space, so the fusion geometry stays coherent),
and a brightness/contrast jitter of the images.

Drawing is split from applying. ``sample_chunk_params`` draws every
sample's angle, flip bits, brightness and contrast from a
``torch.Generator``; ``apply_chunk_augment`` applies them. The JAX package
draws from ``jax.random`` keys, which give other numbers: a test hands the
same parameters to both application functions.
"""
from __future__ import annotations

import math

import torch


def sample_chunk_params(gen: torch.Generator, batch: int, *, flip_prob: float = 0.5, jitter: float = 0.4) -> dict:
    """Per-sample parameters (CPU tensors of shape (batch,)): angle in
    [0, 2 pi), flip_x / flip_y bools (probability ``flip_prob``), brightness
    and contrast in [1 - jitter, 1 + jitter)."""
    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(batch, generator=gen)

    return {
        "angle": uniform(0.0, 2.0 * math.pi),
        "flip_x": torch.rand(batch, generator=gen) < flip_prob,
        "flip_y": torch.rand(batch, generator=gen) < flip_prob,
        "brightness": uniform(1.0 - jitter, 1.0 + jitter),
        "contrast": uniform(1.0 - jitter, 1.0 + jitter),
    }


def _leading(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """(B,) -> (B, 1, ..., 1) broadcasting over a rank-``ndim`` tensor."""
    return t.reshape(t.shape + (1,) * (ndim - 1))


def apply_chunk_augment(points, image_xyz, images, params: dict, *, z_rot: bool = True,
                        flip_prob: float = 0.5, jitter: float = 0.4):
    """points (B, N, 3), image_xyz (B, V, H, W, 3), images (B, V, H, W, 3) in
    [0, 1]; ``params`` from ``sample_chunk_params``. Returns the three,
    augmented as ``augment_chunk`` does each sample:
      * rotation about +z through the points' mean with z zeroed;
      * flips of x, then y, about the mean of the rotated points;
      * (images * brightness - mean) * contrast + mean, clipped to [0, 1],
        with the mean over H and W of each view and channel."""
    B = points.shape[0]
    dev, dt = points.device, points.dtype
    p = {k: v.to(dev) for k, v in params.items()}
    if z_rot:
        c, s = torch.cos(p["angle"]).to(dt), torch.sin(p["angle"]).to(dt)
        zero, one = torch.zeros_like(c), torch.ones_like(c)
        rot = torch.stack([c, -s, zero, s, c, zero, zero, zero, one], dim=-1).reshape(B, 3, 3)
        center = points.mean(dim=1) * torch.tensor([1.0, 1.0, 0.0], dtype=dt, device=dev)  # (B, 3)

        def rotate(x):
            flat = x.reshape(B, -1, 3)
            out = torch.matmul(flat - center[:, None], rot.transpose(1, 2)) + center[:, None]
            return out.reshape(x.shape)

        points, image_xyz = rotate(points), rotate(image_xyz)
    if flip_prob > 0:
        # x flips first, then y, both about the mean of the rotated points;
        # an unflipped axis still goes through (x - c) * 1 + c, as in JAX
        center = points.mean(dim=1)[:, None]  # (B, 1, 3)
        ones = torch.ones(B, dtype=dt, device=dev)
        sx = torch.stack([torch.where(p["flip_x"], -ones, ones), ones, ones], dim=-1)[:, None]
        sy = torch.stack([ones, torch.where(p["flip_y"], -ones, ones), ones], dim=-1)[:, None]

        def flip(x):
            flat = x.reshape(B, -1, 3)
            flat = (flat - center) * sx + center
            return ((flat - center) * sy + center).reshape(x.shape)

        points, image_xyz = flip(points), flip(image_xyz)
    if jitter > 0:
        b = _leading(p["brightness"].to(images.dtype), images.ndim)
        c = _leading(p["contrast"].to(images.dtype), images.ndim)
        mean = images.mean(dim=(-3, -2), keepdim=True)
        images = torch.clamp((images * b - mean) * c + mean, 0.0, 1.0)
    return points, image_xyz, images
