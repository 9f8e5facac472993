"""Scene-level view selection and chunk enumeration.

The host functions of ``mvpnet_tpu/eval/sharded_scene.py`` that the
single-device scene-view-set estimator (eval/scene_fused.py) shares with the
space-sharded one. The sharded estimator itself (ring fusion over the mesh's
space axis) is not ported yet.
"""
from __future__ import annotations

import numpy as np

from mvpnet_torch.config import Config
from mvpnet_torch.data.pipeline import sample_chunk_points
from mvpnet_torch.data.view_select import select_views_for_chunk
from mvpnet_torch.eval.whole_scene import enumerate_chunk_centers, occupied_centers


def select_scene_views(scene, num_views: int, *, max_score_points: int = 2048):
    """Greedy max-coverage view selection over the whole scene point cloud
    (the algorithm the chunk pipeline runs per chunk)."""
    return select_views_for_chunk(
        scene.points,
        scene.depth,
        scene.poses,
        scene.intrinsics,
        num_views,
        max_score_points=max_score_points,
        rng=None,
    )


def enumerate_scene_chunks(scene, cfg: Config):
    """Deterministic sliding chunk windows: list of (point_idx, points).

    The window grid and point sampling of the single-device path
    (``enumerate_chunk_centers`` and ``sample_chunk_points`` with rng=None).
    """
    centers = enumerate_chunk_centers(scene.points, cfg.data.chunk_size, cfg.data.chunk_stride)
    half = cfg.data.chunk_size / 2 + cfg.data.chunk_margin
    chunks = []
    for center in occupied_centers(scene.points, centers, half):
        sel = sample_chunk_points(
            scene, center, cfg.data.num_points, cfg.data.chunk_size, cfg.data.chunk_margin, rng=None
        )
        chunks.append((sel.astype(np.int64), scene.points[sel].astype(np.float32)))
    return chunks
