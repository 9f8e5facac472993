"""The reference's data path: chunk sampling, view selection and the lift.

Frozen from the port's host data path (``mvpnet_torch/data/pipeline.py``,
``view_select.py``, the chunk windows of ``eval/whole_scene.py``) and its
device-side preparation (``train/step.prepare_batch``, ``core/camera.py``,
``core/augment.py``) as the benchmark was written, in NumPy and plain
PyTorch. The port's native grid index and greedy cover are reproduced in
NumPy: points come out of a box query in the grid's cell order (x cells
outer, y cells inner, scene order within a cell), which is the order random
draws over them depend on. Nothing here imports the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch

GRID_CELL = 0.75  # the port's per-scene index cell (pipeline._scene_grid_index)
SENTINEL = 1e6  # world position of an invalid pixel


class Grid:
    """xy grid over a scene's points, queried as the native index does."""

    def __init__(self, points: np.ndarray, cell: float = GRID_CELL):
        p = np.ascontiguousarray(points, np.float32)
        self.x, self.y = p[:, 0], p[:, 1]
        self.min_x, self.min_y = np.float32(self.x.min()), np.float32(self.y.min())
        self.cell = float(cell)
        self.nx = max(1, int(float(np.float32(self.x.max() - self.min_x)) / self.cell) + 1)
        self.ny = max(1, int(float(np.float32(self.y.max() - self.min_y)) / self.cell) + 1)
        cx = np.minimum(((self.x - self.min_x).astype(np.float64) / self.cell).astype(np.int64), self.nx - 1)
        cy = np.minimum(((self.y - self.min_y).astype(np.float64) / self.cell).astype(np.int64), self.ny - 1)
        self.cell_of = cx * self.ny + cy

    def query_box(self, center_xy, half: float) -> np.ndarray:
        cx, cy, half = float(center_xy[0]), float(center_xy[1]), float(half)
        mx, my = float(self.min_x), float(self.min_y)
        x0 = max(0, int((cx - half - mx) / self.cell))
        x1 = min(self.nx - 1, int((cx + half - mx) / self.cell))
        y0 = max(0, int((cy - half - my) / self.cell))
        y1 = min(self.ny - 1, int((cy + half - my) / self.cell))
        gx, gy = self.cell_of // self.ny, self.cell_of % self.ny
        x, y = self.x.astype(np.float64), self.y.astype(np.float64)
        hit = (gx >= x0) & (gx <= x1) & (gy >= y0) & (gy <= y1)
        hit &= (x >= cx - half) & (x <= cx + half) & (y >= cy - half) & (y <= cy + half)
        idx = np.nonzero(hit)[0]
        return idx[np.argsort(self.cell_of[idx], kind="stable")]


def grid(scene: dict) -> Grid:
    g = scene.get("_grid")
    if g is None:
        g = scene["_grid"] = Grid(scene["points"])
    return g


def sample_chunk_points(scene, center_xy, num_points, chunk_size, margin, rng):
    idx = grid(scene).query_box(center_xy, chunk_size / 2 + margin)
    if len(idx) == 0:
        idx = np.arange(len(scene["points"]))
    if rng is None:
        if len(idx) <= num_points:
            return idx[np.arange(num_points) % len(idx)]
        return np.random.default_rng(0xC0FFEE).choice(idx, num_points, replace=False)
    return rng.choice(idx, num_points, replace=len(idx) < num_points)


def point_frame_coverage(points, depth, poses, intrinsics, depth_tol: float = 0.10):
    F_, H, W = depth.shape
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    cover = np.zeros((F_, len(points)), bool)
    for f in range(F_):
        w2c = np.linalg.inv(poses[f].astype(np.float64))
        pc = points @ w2c[:3, :3].T + w2c[:3, 3]
        z = pc[:, 2]
        front = z > 1e-3
        with np.errstate(divide="ignore", invalid="ignore"):
            u = np.round(pc[:, 0] / z * fx + cx).astype(np.int64)
            v = np.round(pc[:, 1] / z * fy + cy).astype(np.int64)
        ok = front & (u >= 0) & (u < W) & (v >= 0) & (v < H)
        d = np.zeros(len(points))
        d[ok] = depth[f, v[ok], u[ok]]
        cover[f] = ok & (d > 0) & (np.abs(d - z) < depth_tol)
    return cover


def greedy_select_views(coverage: np.ndarray, num_views: int) -> np.ndarray:
    """Each pick the unused frame covering the most still-uncovered points
    (first on ties); the first pick repeats when frames run out."""
    F_, N = coverage.shape
    remaining = np.ones(N, bool)
    chosen: list[int] = []
    for _ in range(min(num_views, F_)):
        gains = coverage[:, remaining].sum(axis=1)
        if chosen:
            gains[np.asarray(chosen)] = -1
        best = int(np.argmax(gains))
        chosen.append(best)
        remaining &= ~coverage[best]
    while len(chosen) < num_views:
        chosen.append(chosen[0] if chosen else 0)
    return np.asarray(chosen, np.int64)


def select_views_for_chunk(chunk_points, depth, poses, intrinsics, num_views, *, max_score_points=1024,
                           candidate_frames=None, rng=None):
    pts = chunk_points
    if len(pts) > max_score_points:
        if rng is None:
            sel = np.linspace(0, len(pts) - 1, max_score_points).astype(np.int64)
        else:
            sel = rng.choice(len(pts), max_score_points, replace=False)
        pts = pts[sel]
    if candidate_frames is not None:
        depth = depth[candidate_frames]
        poses = poses[candidate_frames]
    chosen = greedy_select_views(point_frame_coverage(pts, depth, poses, intrinsics), num_views)
    if candidate_frames is not None:
        chosen = np.asarray(candidate_frames)[chosen]
    return chosen


def make_chunk_sample(scene, data: dict, *, center_xy=None, num_views: int, rng=None) -> dict:
    """One chunk in the compact wire format, with ``point_idx``."""
    if center_xy is None:
        labeled = np.nonzero(scene["labels"] != data["ignore_label"])[0]
        pool = labeled if len(labeled) else np.arange(len(scene["points"]))
        pick = rng.choice(pool) if rng is not None else pool[0]
        center_xy = scene["points"][pick, :2]
    sel = sample_chunk_points(scene, center_xy, data["num_points"], data["chunk_size"], data["chunk_margin"], rng)
    chunk_pts = scene["points"][sel]
    num_frames = len(scene["depth"])
    candidates = None
    if num_frames > data["max_candidate_frames"]:
        candidates = (rng.choice(num_frames, data["max_candidate_frames"], replace=False) if rng is not None
                      else np.arange(data["max_candidate_frames"]))
    frames = select_views_for_chunk(chunk_pts, scene["depth"], scene["poses"], scene["intrinsics"], num_views,
                                    candidate_frames=candidates, rng=rng)
    if not data["compact_transfer"]:
        raise ValueError("the reference reads the compact wire format only")
    return {
        "points": np.clip(np.round(chunk_pts * 1000.0), -32767, 32767).astype(np.int16),
        "seg_label": scene["labels"][sel].astype(np.int8),
        "images": np.clip(scene["rgb"][frames] * 255.0 + 0.5, 0, 255).astype(np.uint8),
        "depth": np.clip(scene["depth"][frames] * 1000.0 + 0.5, 0, 65535).astype(np.uint16),
        "poses": scene["poses"][frames].astype(np.float32),
        "intrinsics": scene["intrinsics"].astype(np.float32),
        "seg_label_2d": scene["label_2d"][frames].astype(np.int8),
        "point_idx": sel.astype(np.int64),
    }


def collate(samples) -> dict:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class WorkerStream:
    """The batches of one data worker of a training run: a private
    generator from (seed, worker id), batch after batch, one sample drawn at
    a time (``next_sample``) so a batch can be matched by its first row."""

    def __init__(self, scenes, data: dict, seed: int, worker: int):
        self.scenes, self.data = scenes, data
        self.rng = np.random.default_rng(np.random.SeedSequence([seed, worker]))

    def next_sample(self) -> dict:
        scene = self.scenes[self.rng.integers(len(self.scenes))]
        s = make_chunk_sample(scene, self.data, num_views=self.data["num_views_train"], rng=self.rng)
        s.pop("point_idx")
        return s


def enumerate_chunk_centers(points, chunk_size: float, stride: float):
    lo = points[:, :2].min(axis=0)
    hi = points[:, :2].max(axis=0)
    xs = np.arange(lo[0] + chunk_size / 2, hi[0] + stride, stride)
    ys = np.arange(lo[1] + chunk_size / 2, hi[1] + stride, stride)
    return np.stack(np.meshgrid(xs, ys, indexing="ij"), axis=-1).reshape(-1, 2)


def scene_windows(scene, data: dict) -> list[dict]:
    """The chunk samples of every occupied sliding window, in window order."""
    centers = enumerate_chunk_centers(scene["points"], data["chunk_size"], data["chunk_stride"])
    half = data["chunk_size"] / 2 + data["chunk_margin"]
    out = []
    for center in centers:
        near = np.abs(scene["points"][:, :2] - center)
        if np.any((near[:, 0] <= half) & (near[:, 1] <= half)):
            out.append(make_chunk_sample(scene, data, center_xy=center, num_views=data["num_views_eval"]))
    return out


# --- device side -------------------------------------------------------------


def unproject_views(depth, intrinsics, poses):
    """(B, V, H, W) depth, (B, V, 3, 3), (B, V, 4, 4) -> world xyz with the
    sentinel at invalid pixels, and the validity mask."""
    h, w = depth.shape[-2:]
    fx = intrinsics[..., 0, 0][..., None, None]
    fy = intrinsics[..., 1, 1][..., None, None]
    cx = intrinsics[..., 0, 2][..., None, None]
    cy = intrinsics[..., 1, 2][..., None, None]
    u = torch.arange(w, dtype=depth.dtype, device=depth.device)[None, :]
    v = torch.arange(h, dtype=depth.dtype, device=depth.device)[:, None]
    x = (u - cx) / fx * depth
    y = (v - cy) / fy * depth
    rows = []
    for i in range(3):
        r = poses[..., i, :][..., None, None, :]
        rows.append(r[..., 0] * x + r[..., 1] * y + r[..., 2] * depth + r[..., 3])
    valid = depth > 0
    xyz = torch.where(valid[..., None], torch.stack(rows, dim=-1), torch.tensor(SENTINEL, device=depth.device))
    return xyz, valid


def sample_chunk_params(gen: torch.Generator, batch: int, *, flip_prob: float, jitter: float) -> dict:
    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(batch, generator=gen)

    return {
        "angle": uniform(0.0, 2.0 * math.pi),
        "flip_x": torch.rand(batch, generator=gen) < flip_prob,
        "flip_y": torch.rand(batch, generator=gen) < flip_prob,
        "brightness": uniform(1.0 - jitter, 1.0 + jitter),
        "contrast": uniform(1.0 - jitter, 1.0 + jitter),
    }


def apply_chunk_augment(points, image_xyz, images, params, *, z_rot: bool, flip_prob: float, jitter: float):
    B = points.shape[0]
    dev = points.device
    p = {k: v.to(dev) for k, v in params.items()}
    if z_rot:
        c, s = torch.cos(p["angle"]), torch.sin(p["angle"])
        zero, one = torch.zeros_like(c), torch.ones_like(c)
        rot = torch.stack([c, -s, zero, s, c, zero, zero, zero, one], dim=-1).reshape(B, 3, 3)
        center = points.mean(dim=1) * torch.tensor([1.0, 1.0, 0.0], device=dev)

        def rotate(x):
            flat = x.reshape(B, -1, 3)
            return (torch.matmul(flat - center[:, None], rot.transpose(1, 2)) + center[:, None]).reshape(x.shape)

        points, image_xyz = rotate(points), rotate(image_xyz)
    if flip_prob > 0:
        center = points.mean(dim=1)[:, None]
        ones = torch.ones(B, device=dev)
        sx = torch.stack([torch.where(p["flip_x"], -ones, ones), ones, ones], dim=-1)[:, None]
        sy = torch.stack([ones, torch.where(p["flip_y"], -ones, ones), ones], dim=-1)[:, None]

        def flip(x):
            flat = x.reshape(B, -1, 3)
            flat = (flat - center) * sx + center
            return ((flat - center) * sy + center).reshape(x.shape)

        points, image_xyz = flip(points), flip(image_xyz)
    if jitter > 0:
        b = p["brightness"].reshape(B, 1, 1, 1, 1)
        c = p["contrast"].reshape(B, 1, 1, 1, 1)
        mean = images.mean(dim=(-3, -2), keepdim=True)
        images = torch.clamp((images * b - mean) * c + mean, 0.0, 1.0)
    return points, image_xyz, images


def prepare(batch: dict, data: dict, *, generator=None) -> dict:
    """A compact chunk batch on the device -> the model's inputs: dequantized,
    lifted, augmented when a ``generator`` is given; 2D labels ignored where
    the depth is invalid."""
    images = batch["images"].float() / 255.0
    depth = batch["depth"].float() / 1000.0
    points = batch["points"].float() / 1000.0
    intr = batch["intrinsics"][:, None].expand(depth.shape[:2] + (3, 3))
    image_xyz, valid = unproject_views(depth, intr, batch["poses"])
    if generator is not None and data["augment"]:
        params = sample_chunk_params(generator, points.shape[0], flip_prob=data["flip_prob"], jitter=data["color_jitter"])
        points, image_xyz, images = apply_chunk_augment(points, image_xyz, images, params, z_rot=data["z_rot"],
                                                        flip_prob=data["flip_prob"], jitter=data["color_jitter"])
    label2d = batch["seg_label_2d"].to(torch.int64)
    return {
        "points": points,
        "images": images,
        "image_xyz": image_xyz,
        "seg_label": batch["seg_label"].to(torch.int64),
        "seg_label_2d": torch.where(valid, label2d, data["ignore_label"]),
    }
