"""Single-device whole-scene inference with a per-scene view set and a
prepared pixel cloud.

Counterpart of ``mvpnet_tpu/eval/scene_fused.py``, the estimator of the
space-sharded mode on one device: one view set is selected for the whole
scene, the lift and the 2D net run once per scene, the pixel cloud is
``ops.knn_prepare``'d once, and every chunk window's fusion kNN runs
``ops.knn_prepared`` against it (the fusion kernel on the card). Windows go
through the 3D net in groups of ``cfg.eval.batch_size``, each group as one
(1, G*N) query set over the scene cloud. The accumulator stays on the
device and is filled there (``whole_scene.nn_fill``).
"""
from __future__ import annotations

import numpy as np
import torch

from mvpnet_torch import ops
from mvpnet_torch.config import Config
from mvpnet_torch.core.camera import unproject_views
from mvpnet_torch.eval.sharded_scene import enumerate_scene_chunks, select_scene_views
from mvpnet_torch.eval.whole_scene import accum_scene_logits, model_device, nn_fill


def build_scene_fused_fns(model, cfg: Config):
    """(pixel_fn, prepare_fn, fuse_fn); reuse across scenes.

    pixel_fn(images (V,H,W,3), depth (V,H,W), poses (V,4,4), intrinsics
             (3,3)) -> pixel_xyz (1, V*H*W, 3), pixel_feat (1, V*H*W, C2d):
             lift + 2D features, once per scene.
    prepare_fn(pixel_xyz) -> the prepared cloud (``ops.knn_prepare``).
    fuse_fn(chunk_pts (G,N,3), prepared, pixel_xyz, pixel_feat) -> logits
             (G, N, num_classes): prepared kNN + aggregation + PN2SSG for a
             group of chunk windows.
    """
    model.eval()
    k = cfg.model.aggregation.k

    @torch.no_grad()
    def pixel_fn(images, depth, poses, intrinsics):
        xyz, _ = unproject_views(depth, intrinsics, poses)  # (V, H, W, 3)
        feat, _ = model.net_2d(images)  # (V, H, W, C2d)
        v, h, w, c = feat.shape
        return xyz.reshape(1, v * h * w, 3), feat.reshape(1, v * h * w, c)

    @torch.no_grad()
    def fuse_fn(chunk_pts, prepared, pixel_xyz, pixel_feat):
        G, n, _ = chunk_pts.shape
        _, idx = ops.knn_prepared(chunk_pts.reshape(1, G * n, 3), prepared, k)  # (1, G*n, k)
        gfeat = ops.group_points(pixel_feat, idx).reshape(G, n, k, -1)
        gxyz = ops.group_points(pixel_xyz, idx).reshape(G, n, k, 3)
        fused = model.aggregation(chunk_pts, gxyz, gfeat)
        return model.net_3d(chunk_pts, fused)

    return pixel_fn, ops.knn_prepare, fuse_fn


def predict_scene_fused(
    model,
    cfg: Config,
    scene,
    *,
    num_views: int | None = None,
    chunk_group: int | None = None,
    fns=None,
) -> np.ndarray:
    """Accumulated per-point logits (P, num_classes): scene-view-set
    execution with one prepared pixel cloud per scene, on the model's
    device."""
    vt = min(num_views or cfg.eval.scene_views, len(scene.depth))
    G = chunk_group or cfg.eval.batch_size
    pixel_fn, prepare_fn, fuse_fn = fns or build_scene_fused_fns(model, cfg)
    device = model_device(model)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    frames = select_scene_views(scene, vt)
    pixel_xyz, pixel_feat = pixel_fn(
        put(scene.rgb[frames]), put(scene.depth[frames]), put(scene.poses[frames]), put(scene.intrinsics)
    )
    prepared = prepare_fn(pixel_xyz)

    P = len(scene.points)
    acc = torch.zeros((P, cfg.data.num_classes), dtype=torch.float32, device=device)
    cnt = torch.zeros((P,), dtype=torch.int32, device=device)
    chunks = enumerate_scene_chunks(scene, cfg)
    for start in range(0, len(chunks), G):
        group = chunks[start : start + G]  # the last group runs at its own size
        pts = put(np.stack([g[1] for g in group]))  # (Gr, N, 3)
        idx = torch.from_numpy(np.stack([g[0] for g in group])).to(device)  # (Gr, N)
        accum_scene_logits(acc, cnt, fuse_fn(pts, prepared, pixel_xyz, pixel_feat), idx)

    nn_fill(scene.points, acc, cnt)
    return acc.cpu().numpy()
