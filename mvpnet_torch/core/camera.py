"""Camera model + depth unprojection (the "lift" stage).

Counterpart of ``mvpnet_tpu/core/camera.py``: depth in meters (<= 0 marks an
invalid pixel), pinhole intrinsics (3, 3), camera-to-world poses (4, 4),
outputs channels-last. The rotation is applied as explicit f32
multiply-adds, never as a matmul that could reach a TF32 tensor core.
"""
from __future__ import annotations

import torch


def unproject_depth(depth: torch.Tensor, intrinsics: torch.Tensor):
    """(..., H, W) depth, (..., 3, 3) intrinsics -> camera-space xyz
    (..., H, W, 3) and the validity mask (..., H, W) of positive depth."""
    h, w = depth.shape[-2:]
    fx = intrinsics[..., 0, 0][..., None, None]
    fy = intrinsics[..., 1, 1][..., None, None]
    cx = intrinsics[..., 0, 2][..., None, None]
    cy = intrinsics[..., 1, 2][..., None, None]
    u = torch.arange(w, dtype=depth.dtype, device=depth.device)[None, :]
    v = torch.arange(h, dtype=depth.dtype, device=depth.device)[:, None]
    x = (u - cx) / fx * depth
    y = (v - cy) / fy * depth
    return torch.stack([x, y, depth], dim=-1), depth > 0


def world_from_camera(xyz_cam: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) camera-to-world poses to (..., H, W, 3) points."""
    x, y, z = xyz_cam[..., 0], xyz_cam[..., 1], xyz_cam[..., 2]
    rows = []
    for i in range(3):
        r = pose[..., i, :][..., None, None, :]  # (..., 1, 1, 4)
        rows.append(r[..., 0] * x + r[..., 1] * y + r[..., 2] * z + r[..., 3])
    return torch.stack(rows, dim=-1)


def unproject_views(depth, intrinsics, poses, fill_value: float = 1e6):
    """Lift V posed depth maps (..., V, H, W) into world space.

    ``intrinsics`` is (3, 3) or (..., V, 3, 3); invalid pixels get the
    ``fill_value`` sentinel in every coordinate, which keeps them out of
    every kNN ball without ragged shapes. Returns xyz (..., V, H, W, 3) and
    valid (..., V, H, W)."""
    if intrinsics.ndim == 2:
        intrinsics = intrinsics.expand(depth.shape[:-2] + (3, 3))
    xyz_cam, valid = unproject_depth(depth, intrinsics)
    xyz_w = world_from_camera(xyz_cam, poses)
    xyz_w = torch.where(valid[..., None], xyz_w, xyz_w.new_tensor(fill_value))
    return xyz_w, valid
