"""Greedy max-coverage view selection (host-side, NumPy).

The port's copy of ``mvpnet_tpu/data/view_select.py``; the native greedy
cover comes from ``mvpnet_torch.data.native``.

Reference semantics [C] (``ScanNet2D3DChunks`` helpers, scannet_2d3d.py
UNVERIFIED; SURVEY.md §3.4): repeat k times, each time picking the frame
that covers the most not-yet-covered chunk points. This stays on the host by
design — it is a tiny argmax over per-frame boolean coverage vectors
(SURVEY.md §7 layer 5: "greedy coverage stays on host — it's tiny");
everything downstream (lift, kNN, fusion) runs on-device.
"""
from __future__ import annotations

import numpy as np


def point_frame_coverage(
    points: np.ndarray,
    depth: np.ndarray,
    poses: np.ndarray,
    intrinsics: np.ndarray,
    depth_tol: float = 0.10,
) -> np.ndarray:
    """Boolean coverage matrix: which frames see which points.

    A point is covered by a frame when it projects in-bounds with positive
    camera z AND the frame's depth at that pixel agrees within ``depth_tol``
    meters (visibility test — occluded or hole pixels don't count).

    Args:
      points: (N, 3) world points.
      depth: (F, H, W) depth maps (0 = invalid).
      poses: (F, 4, 4) camera-to-world.
      intrinsics: (3, 3).

    Returns:
      (F, N) bool.
    """
    F, H, W = depth.shape
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    cover = np.zeros((F, len(points)), bool)
    for f in range(F):
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


def greedy_select_views(
    coverage: np.ndarray, num_views: int
) -> tuple[np.ndarray, np.ndarray]:
    """Greedy max-coverage frame selection.

    Args:
      coverage: (F, N) bool point-frame coverage.
      num_views: frames to pick (frames may repeat only if F < num_views).

    Returns:
      (num_views,) int frame indices, (N,) bool covered-point mask.
    """
    F, N = coverage.shape
    from mvpnet_torch.data.native import greedy_cover_native

    if num_views <= F:
        native = greedy_cover_native(coverage, num_views)
        if native is not None:
            covered = coverage[native].any(axis=0)
            return native.astype(np.int64), covered
    remaining = np.ones(N, bool)
    chosen: list[int] = []
    for _ in range(min(num_views, F)):
        gains = coverage[:, remaining].sum(axis=1)
        if chosen:
            gains[np.asarray(chosen)] = -1
        best = int(np.argmax(gains))
        chosen.append(best)
        remaining &= ~coverage[best]
    # pad by repeating the best frame if fewer frames than requested
    while len(chosen) < num_views:
        chosen.append(chosen[0] if chosen else 0)
    covered = ~remaining
    return np.asarray(chosen, np.int64), covered


def select_views_for_chunk(
    chunk_points: np.ndarray,
    depth: np.ndarray,
    poses: np.ndarray,
    intrinsics: np.ndarray,
    num_views: int,
    *,
    max_score_points: int = 1024,
    candidate_frames: np.ndarray | None = None,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """End-to-end helper: score coverage on a subsample of chunk points and
    greedily pick ``num_views`` frame indices."""
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
    cover = point_frame_coverage(pts, depth, poses, intrinsics)
    chosen, _ = greedy_select_views(cover, num_views)
    if candidate_frames is not None:
        chosen = np.asarray(candidate_frames)[chosen]
    return chosen
