"""Space-sharded whole-scene inference, and the scene-level view selection
and chunk windows it shares with the fused estimator.

Counterpart of ``mvpnet_tpu/eval/sharded_scene.py``: a whole scene evaluated
over the ``space`` axis of a mesh (``dist/mesh.py``) —

  * ONE view set is selected for the whole scene (greedy max coverage),
    padded to a multiple of the shard count with depth-0 frames, and split
    over the space shards; each shard lifts and runs the 2D net over only
    its views, so the 2D work and the pixel cloud are both sharded;
  * chunk windows go in passes of ``chunks_per_shard`` windows a shard
    (the last pass padded with its last window); each window point's k
    nearest pixels may lie in any shard's block, so the fusion runs the ring
    of ``dist/fusion.py``: S - 1 hops rotate the pixel blocks while each
    shard folds them into a running top-k;
  * each shard runs FeatureAggregation and PN2SSG on its windows, the
    logits are gathered over the space group to the host and
    scatter-accumulated there; uncovered points are filled from their
    nearest scored neighbor.

On a process mesh every space group computes the whole scene (data ranks
repeat it, as JAX's replicated ``P()`` does); on the loopback mesh one
process holds every shard. The single-device mode (eval/whole_scene.py)
selects views per chunk; this one selects one view set a scene, so it
estimates what eval/scene_fused.py does on one device.
"""
from __future__ import annotations

import numpy as np
import torch

from mvpnet_torch.config import Config
from mvpnet_torch.core.camera import unproject_views
from mvpnet_torch.data.pipeline import sample_chunk_points
from mvpnet_torch.data.view_select import select_views_for_chunk
from mvpnet_torch.dist.fusion import ring_knn_local
from mvpnet_torch.eval.whole_scene import enumerate_chunk_centers, model_device, nn_fill_uncovered, occupied_centers


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


def build_sharded_scene_fns(model, cfg: Config, mesh):
    """(pixel_fn, fuse_fn) over the mesh's space axis; reuse across scenes.

    pixel_fn(images (Vl,H,W,3), depth (Vl,H,W), poses (Vl,4,4), intrinsics
             (3,3)) -> pixel_xyz (Vl*H*W, 3), pixel_feat (Vl*H*W, C2d): one
             shard's lift and 2D features (no traffic).
    fuse_fn(chunk_pts, pixel_xyz, pixel_feat) -> logits: lists with one
             entry for each shard this process holds (``mesh.shards``):
             windows (Gl, N, 3) and the shard's pixel block; returns each
             shard's (Gl, N, num_classes) after the ring fusion and its
             local aggregation and 3D net.
    """
    model.eval()
    k = cfg.model.aggregation.k

    @torch.no_grad()
    def pixel_fn(images, depth, poses, intrinsics):
        xyz, _ = unproject_views(depth, intrinsics, poses)  # (Vl, H, W, 3)
        feat, _ = model.net_2d(images)  # (Vl, H, W, C2d)
        vl, h, w, c = feat.shape
        return xyz.reshape(vl * h * w, 3), feat.reshape(vl * h * w, c)

    @torch.no_grad()
    def fuse_fn(chunk_pts: list, pixel_xyz: list, pixel_feat: list) -> list:
        flat = [p.reshape(-1, 3) for p in chunk_pts]
        if mesh.loopback:
            fused = ring_knn_local(flat, pixel_xyz, pixel_feat, k=k, mesh=mesh)
        else:
            fused = [ring_knn_local(flat[0], pixel_xyz[0], pixel_feat[0], k=k, mesh=mesh)]
        logits = []
        for pts, (_, gxyz, gfeat) in zip(chunk_pts, fused):
            gl, n, _ = pts.shape
            agg = model.aggregation(pts, gxyz.reshape(gl, n, k, 3), gfeat.reshape(gl, n, k, -1))
            logits.append(model.net_3d(pts, agg))
        return logits

    return pixel_fn, fuse_fn


def _pad_views(images, depth, poses, multiple: int):
    """Pad the view axis to a multiple of the shard count with depth-0 frames
    (every pixel invalid: the sentinel position, which never wins a kNN
    while a real pixel is left) and identity poses."""
    v = len(depth)
    pad = (-v) % multiple
    if pad == 0:
        return images, depth, poses
    images = np.concatenate([images, np.zeros((pad,) + images.shape[1:], images.dtype)])
    depth = np.concatenate([depth, np.zeros((pad,) + depth.shape[1:], depth.dtype)])
    poses = np.concatenate([poses, np.tile(np.eye(4, dtype=poses.dtype), (pad, 1, 1))])
    return images, depth, poses


def predict_scene_sharded(
    model,
    cfg: Config,
    scene,
    mesh,
    *,
    num_views: int | None = None,
    chunks_per_shard: int | None = None,
    fns=None,
) -> np.ndarray:
    """Accumulated per-point logits (P, num_classes), space-sharded, on the
    model's device. ``fns`` (from ``build_sharded_scene_fns``) can be reused
    across scenes."""
    S = mesh.space
    vt = min(num_views or cfg.eval.scene_views, len(scene.depth))
    per_shard = chunks_per_shard or cfg.eval.chunks_per_shard
    G = per_shard * S  # windows a pass
    pixel_fn, fuse_fn = fns or build_sharded_scene_fns(model, cfg, mesh)
    device = model_device(model)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    frames = select_scene_views(scene, vt)
    images, depth, poses = _pad_views(
        scene.rgb[frames].astype(np.float32),
        scene.depth[frames].astype(np.float32),
        scene.poses[frames].astype(np.float32),
        S,
    )
    vl = len(depth) // S
    intrinsics = put(scene.intrinsics)
    blocks = [
        pixel_fn(put(images[s * vl : (s + 1) * vl]), put(depth[s * vl : (s + 1) * vl]),
                 put(poses[s * vl : (s + 1) * vl]), intrinsics)
        for s in mesh.shards
    ]
    pixel_xyz, pixel_feat = [b[0] for b in blocks], [b[1] for b in blocks]

    chunks = enumerate_scene_chunks(scene, cfg)
    logits_acc = np.zeros((len(scene.points), cfg.data.num_classes), np.float32)
    counts = np.zeros(len(scene.points), np.int32)
    for start in range(0, len(chunks), G):
        group = chunks[start : start + G]
        n_real = len(group)
        group += [group[-1]] * (G - n_real)  # the pass's fixed shape
        pts = np.stack([g[1] for g in group])  # (G, N, 3)
        out = fuse_fn([put(pts[s * per_shard : (s + 1) * per_shard]) for s in mesh.shards], pixel_xyz, pixel_feat)
        parts = out if mesh.loopback else mesh.gather_space(out[0])
        logits = torch.cat(parts).float().cpu().numpy()
        for i in range(n_real):
            np.add.at(logits_acc, group[i][0], logits[i])
            np.add.at(counts, group[i][0], 1)
    # the accumulator is on the host, so the fill is too; an empty scene has
    # no window: every point is filled (with zeros)
    nn_fill_uncovered(scene.points, logits_acc, counts)
    return logits_acc
