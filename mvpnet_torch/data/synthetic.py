"""Synthetic indoor-scene generator with posed RGB-D views.

The port's copy of ``mvpnet_tpu/data/synthetic.py``: the same seed gives the
same arrays.

Stands in for ScanNet when no real data is on disk: random rooms built from labeled surfaces (floor, walls, furniture
boxes), densely point-sampled, plus RGB-D views rendered by point-splatting
into pinhole cameras. The renderer is exactly consistent with
``mvpnet_torch.core.camera.unproject_depth`` — unprojecting a rendered depth map
reproduces scene-point positions — which makes it a strong oracle for the
lift + kNN fusion path (SURVEY.md §4 implication 3: "synthetic mini-scene
with analytically known labels").

Its ``Scene`` has the layout of the JAX package's ScanNet scenes, so the
chunk functions do not depend on the source.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Scene:
    """One scene: a labeled point cloud + posed RGB-D frames."""

    name: str
    points: np.ndarray  # (P, 3) float32 world xyz
    colors: np.ndarray  # (P, 3) float32 in [0, 1]
    labels: np.ndarray  # (P,) int32 train ids (ignore_label for unlabeled)
    # frames
    depth: np.ndarray  # (F, H, W) float32 meters, 0 = invalid
    rgb: np.ndarray  # (F, H, W, 3) float32 in [0, 1]
    label_2d: np.ndarray  # (F, H, W) int32 (ignore_label where invalid)
    poses: np.ndarray  # (F, 4, 4) float32 camera-to-world
    intrinsics: np.ndarray  # (3, 3) float32
    extra: dict = field(default_factory=dict)


def _look_at_pose(eye, target, up=(0.0, 0.0, 1.0)):
    """Camera-to-world with +z forward, +x right, +y down (image convention)."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd = fwd / (np.linalg.norm(fwd) + 1e-12)
    right = np.cross(fwd, np.asarray(up, np.float64))
    nr = np.linalg.norm(right)
    if nr < 1e-6:  # looking straight up/down
        right = np.array([1.0, 0.0, 0.0])
    else:
        right = right / nr
    down = np.cross(fwd, right)
    pose = np.eye(4)
    pose[:3, 0] = right
    pose[:3, 1] = down
    pose[:3, 2] = fwd
    pose[:3, 3] = eye
    return pose.astype(np.float32)


def _sample_box_surface(rng, center, size, n):
    """Uniform points on the surface of an axis-aligned box."""
    size = np.asarray(size, np.float32)
    areas = np.array(
        [size[1] * size[2], size[1] * size[2],
         size[0] * size[2], size[0] * size[2],
         size[0] * size[1], size[0] * size[1]]
    )
    face = rng.choice(6, size=n, p=areas / areas.sum())
    u = rng.uniform(-0.5, 0.5, size=(n, 3)).astype(np.float32)
    pts = u * size
    axis = face // 2
    sign = np.where(face % 2 == 0, 0.5, -0.5)
    pts[np.arange(n), axis] = sign * size[axis]
    return pts + np.asarray(center, np.float32)


def render_pointcloud(points, colors, labels, pose, intrinsics, h, w, ignore_label=-100):
    """Point-splat z-buffer render: depth, rgb, and label images.

    Pixels no point lands in get depth 0 (invalid) — mimicking sensor holes
    and exercising the validity-mask path end-to-end.
    """
    world2cam = np.linalg.inv(pose.astype(np.float64))
    pc = points @ world2cam[:3, :3].T + world2cam[:3, 3]
    z = pc[:, 2]
    front = z > 0.05
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        u = np.round(pc[:, 0] / z * fx + cx).astype(np.int64)
        v = np.round(pc[:, 1] / z * fy + cy).astype(np.int64)
    ok = front & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    idx = np.nonzero(ok)[0]
    # z-buffer: sort far-to-near so the nearest point wins the final write
    order = np.argsort(-z[idx])
    idx = idx[order]
    lin = v[idx] * w + u[idx]

    depth = np.zeros(h * w, np.float32)
    rgb = np.zeros((h * w, 3), np.float32)
    lab = np.full(h * w, ignore_label, np.int32)
    depth[lin] = z[idx]
    rgb[lin] = colors[idx]
    lab[lin] = labels[idx]
    return depth.reshape(h, w), rgb.reshape(h, w, 3), lab.reshape(h, w)


def make_scene(
    seed: int = 0,
    *,
    num_points: int = 60000,
    num_frames: int = 12,
    height: int = 120,
    width: int = 160,
    num_classes: int = 20,
    num_objects: int = 6,
    room: float = 4.0,
    wall_height: float = 2.5,
    ignore_label: int = -100,
    name: str | None = None,
) -> Scene:
    """Build a random labeled room and render posed RGB-D frames of it."""
    rng = np.random.default_rng(seed)
    surfaces = []  # (points, label)

    n_floor = num_points // 4
    floor = np.stack(
        [
            rng.uniform(0, room, n_floor),
            rng.uniform(0, room, n_floor),
            np.zeros(n_floor),
        ],
        axis=1,
    ).astype(np.float32)
    surfaces.append((floor, 1))  # floor class

    n_wall = num_points // 8
    for wall_idx in range(4):
        t = rng.uniform(0, room, n_wall)
        z = rng.uniform(0, wall_height, n_wall)
        if wall_idx == 0:
            pts = np.stack([t, np.zeros(n_wall), z], axis=1)
        elif wall_idx == 1:
            pts = np.stack([t, np.full(n_wall, room), z], axis=1)
        elif wall_idx == 2:
            pts = np.stack([np.zeros(n_wall), t, z], axis=1)
        else:
            pts = np.stack([np.full(n_wall, room), t, z], axis=1)
        surfaces.append((pts.astype(np.float32), 0))  # wall class

    n_left = num_points - n_floor - 4 * n_wall
    n_obj = max(n_left // max(num_objects, 1), 1)
    for obj in range(num_objects):
        center = np.array(
            [
                rng.uniform(0.6, room - 0.6),
                rng.uniform(0.6, room - 0.6),
                rng.uniform(0.2, 0.8),
            ]
        )
        size = rng.uniform(0.3, 1.0, size=3)
        label = int(rng.integers(2, num_classes))
        pts = _sample_box_surface(rng, center, size, n_obj)
        surfaces.append((pts, label))

    points = np.concatenate([s[0] for s in surfaces]).astype(np.float32)
    labels = np.concatenate(
        [np.full(len(s[0]), s[1], np.int32) for s in surfaces]
    )
    # deterministic distinct color per class + small texture noise
    colors = (np.stack([labels * 37 % 255, labels * 91 % 255, labels * 151 % 255], -1) / 255.0).astype(np.float32)
    colors = np.clip(colors + rng.normal(0, 0.05, colors.shape), 0, 1).astype(
        np.float32
    )

    fx = 0.6 * width
    intrinsics = np.array(
        [[fx, 0, width / 2 - 0.5], [0, fx, height / 2 - 0.5], [0, 0, 1]],
        np.float32,
    )

    poses, depths, rgbs, labs = [], [], [], []
    for f in range(num_frames):
        eye = np.array(
            [
                rng.uniform(0.5, room - 0.5),
                rng.uniform(0.5, room - 0.5),
                rng.uniform(1.2, wall_height - 0.2),
            ]
        )
        target = np.array(
            [rng.uniform(0.5, room - 0.5), rng.uniform(0.5, room - 0.5), rng.uniform(0.0, 1.0)]
        )
        pose = _look_at_pose(eye, target)
        d, c, l = render_pointcloud(
            points, colors, labels, pose, intrinsics, height, width, ignore_label
        )
        poses.append(pose)
        depths.append(d)
        rgbs.append(c)
        labs.append(l)

    return Scene(
        name=name or f"synthetic_{seed:04d}",
        points=points,
        colors=colors,
        labels=labels,
        depth=np.stack(depths),
        rgb=np.stack(rgbs),
        label_2d=np.stack(labs),
        poses=np.stack(poses),
        intrinsics=intrinsics,
    )
