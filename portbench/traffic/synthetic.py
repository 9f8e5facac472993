"""The traffic generator: a frozen copy of the port's synthetic scene maker.

``make_scene`` is ``mvpnet_torch/data/synthetic.make_scene`` as it stood when
the benchmark was written, returning the arrays of a scene instead of the
port's ``Scene``. Later changes to the port's copy do not move the yardstick:
the same seed gives the same room, points, labels and rendered RGB-D frames
here whatever the program does. A test holds the two copies equal at one seed.

``corpus`` makes a cell's scenes from its traffic file and the run's seed,
one scene a process (the renderer is NumPy bound to the interpreter lock).
"""
from __future__ import annotations

import multiprocessing
import os

import numpy as np

THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")

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
) -> dict:
    """Build a random labeled room and render posed RGB-D frames of it;
    returns the arrays of the port's ``Scene`` under its field names."""
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

    return {
        "name": name or f"synthetic_{seed:04d}",
        "points": points,
        "colors": colors,
        "labels": labels,
        "depth": np.stack(depths),
        "rgb": np.stack(rgbs),
        "label_2d": np.stack(labs),
        "poses": np.stack(poses),
        "intrinsics": intrinsics,
    }


def scene_seeds(seed: int, count: int) -> list[int]:
    """``count`` scene seeds drawn from a run's ``--seed`` (any size)."""
    return [int(s) for s in np.random.SeedSequence(int(seed)).generate_state(count, np.uint32)]


def _make(args):
    seed, params = args
    return make_scene(seed, **params)


def scene_params(traffic: dict, cfg: dict) -> dict:
    """``make_scene``'s keyword arguments: the traffic's room, the config's
    image size, classes and ignore label."""
    data = cfg["data"]
    return {
        "num_points": int(traffic["points"]),
        "num_frames": int(traffic["frames"]),
        "num_objects": int(traffic["objects"]),
        "room": float(traffic["room"]),
        "height": int(data["image_height"]),
        "width": int(data["image_width"]),
        "num_classes": int(data["num_classes"]),
        "ignore_label": int(data["ignore_label"]),
    }


class Corpus:
    """The scenes of one run, made in the background by a pool of spawned
    processes: ``start`` returns at once, ``scenes()`` waits for them and
    stops the pool."""

    def __init__(self, traffic: dict, cfg: dict, seed: int, processes: int | None = None):
        count = int(traffic["scenes"])
        self.seeds = scene_seeds(seed, count)
        params = scene_params(traffic, cfg)
        n = max(1, min(count, processes or multiprocessing.cpu_count()))
        # one thread a process: NumPy's threaded BLAS in every process at
        # once oversubscribes the cores many times over
        saved = {k: os.environ.get(k) for k in THREAD_VARS}
        os.environ.update({k: "1" for k in THREAD_VARS})
        try:
            self._pool = multiprocessing.get_context("spawn").Pool(n)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        self._async = self._pool.map_async(_make, [(s, params) for s in self.seeds], chunksize=1)
        self._scenes = None

    def scenes(self) -> list[dict]:
        if self._scenes is None:
            try:
                self._scenes = self._async.get()
            finally:
                self._async = None
                self.close()
        return self._scenes

    def close(self) -> None:
        if self._pool is not None:
            self._pool.close()
            self._pool.join()
            self._pool = None
