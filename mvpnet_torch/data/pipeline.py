"""Host-side chunk building.

The port's copy of the host functions of ``mvpnet_tpu/data/pipeline.py``:
chunk point sampling, greedy view selection and array slicing, in NumPy.
What runs on the device (dequantization, the lift, the fusion kNN) is
``mvpnet_torch.train.step.prepare_batch`` and the model. The chunk dataset,
its prefetcher and the dataset factory are not ported yet.

Samples are fixed-shape: N points sampled with replacement, V views, HxW
images.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from mvpnet_torch.config import DataConfig
from mvpnet_torch.data.synthetic import Scene
from mvpnet_torch.data.view_select import select_views_for_chunk


def _scene_grid_index(scene: Scene, cell: float = 0.75):
    """Per-scene native CSR grid index, cached on the scene (data/native.py)."""
    from mvpnet_torch.data.native import GridIndex

    gi = scene.extra.get("grid_index")
    if gi is None:
        gi = GridIndex(scene.points, cell=cell)
        scene.extra["grid_index"] = gi
    return gi


def sample_chunk_points(
    scene: Scene,
    center_xy: np.ndarray,
    num_points: int,
    chunk_size: float,
    margin: float,
    rng: np.random.Generator | None,
) -> np.ndarray:
    """Find points inside a (chunk_size+2*margin)^2 xy column and sample
    exactly ``num_points`` indices (with replacement when short)."""
    half = chunk_size / 2 + margin
    idx = _scene_grid_index(scene).query_box(center_xy, half)
    if len(idx) == 0:
        idx = np.arange(len(scene.points))
    if rng is None:
        if len(idx) <= num_points:
            sel = idx[np.arange(num_points) % len(idx)]
        else:
            # deterministic but unbiased subsample (fixed seed): truncating in
            # storage order would systematically drop the tail of dense windows
            sel = np.random.default_rng(0xC0FFEE).choice(idx, num_points, replace=False)
    else:
        sel = rng.choice(idx, num_points, replace=len(idx) < num_points)
    return sel


def make_chunk_sample(
    scene: Scene,
    cfg: DataConfig,
    *,
    center_xy: np.ndarray | None = None,
    num_views: int | None = None,
    rng: np.random.Generator | None = None,
) -> dict:
    """Assemble one fixed-shape chunk sample (host side, NumPy).

    Returns dict of arrays:
      points (N,3) f32, colors (N,3) f32, seg_label (N,) i32,
      images (V,H,W,3) f32, depth (V,H,W) f32, poses (V,4,4) f32,
      intrinsics (3,3) f32, seg_label_2d (V,H,W) i32, point_idx (N,) i64.
    With ``cfg.compact_transfer`` the wire format is compact instead: uint8
    images, uint16 millimeter depth, int16 millimeter points, int8 labels
    (``prepare_batch`` dequantizes them on the device).
    """
    V = num_views or cfg.num_views_train
    if center_xy is None:
        labeled = np.nonzero(scene.labels != cfg.ignore_label)[0]
        pool = labeled if len(labeled) else np.arange(len(scene.points))
        pick = rng.choice(pool) if rng is not None else pool[0]
        center_xy = scene.points[pick, :2]

    sel = sample_chunk_points(scene, center_xy, cfg.num_points, cfg.chunk_size, cfg.chunk_margin, rng)
    chunk_pts = scene.points[sel]

    num_frames = len(scene.depth)
    candidates = None
    if num_frames > cfg.max_candidate_frames:
        candidates = (
            rng.choice(num_frames, cfg.max_candidate_frames, replace=False)
            if rng is not None
            else np.arange(cfg.max_candidate_frames)
        )
    frames = select_views_for_chunk(
        chunk_pts,
        scene.depth,
        scene.poses,
        scene.intrinsics,
        V,
        candidate_frames=candidates,
        rng=rng,
    )

    if cfg.compact_transfer:
        # points as int16 mm: +-32.7 m range, 0.5 mm quantization; class ids
        # < 128 and ignore_label=-100 fit int8
        images = np.clip(scene.rgb[frames] * 255.0 + 0.5, 0, 255).astype(np.uint8)
        depth = np.clip(scene.depth[frames] * 1000.0 + 0.5, 0, 65535).astype(np.uint16)
        points = np.clip(np.round(chunk_pts * 1000.0), -32767, 32767).astype(np.int16)
        seg_label = scene.labels[sel].astype(np.int8)
        seg_label_2d = scene.label_2d[frames].astype(np.int8)
    else:
        images = scene.rgb[frames].astype(np.float32)
        depth = scene.depth[frames].astype(np.float32)
        points = chunk_pts.astype(np.float32)
        seg_label = scene.labels[sel].astype(np.int32)
        seg_label_2d = scene.label_2d[frames].astype(np.int32)
    return {
        "points": points,
        "colors": scene.colors[sel].astype(np.float32),
        "seg_label": seg_label,
        "images": images,
        "depth": depth,
        "poses": scene.poses[frames].astype(np.float32),
        "intrinsics": scene.intrinsics.astype(np.float32),
        "seg_label_2d": seg_label_2d,
        "point_idx": sel.astype(np.int64),
    }


def collate(samples: Sequence[dict]) -> dict:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}
