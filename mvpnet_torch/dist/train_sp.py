"""Space-sharded training: the ring fusion inside the train step.

Counterpart of ``mvpnet_tpu/dist/train_sp.py``. JAX keeps one logical
program and lets GSPMD partition it; here each rank runs its part and the
step is rebuilt exact against the unsharded one by hand:

  * the ranks of one space group load the same chunks (points and labels
    replicated over space) and split the views: ``images``, ``depth``,
    ``poses`` and ``seg_label_2d`` are cut on their view axis
    (``batch_specs``), so each rank lifts and runs the 2D net on V/S views;
  * each rank fuses N/S points of each chunk: the ring kNN of
    ``dist/fusion.py`` over its pixel block, differentiable, so the gradient
    of a gathered feature returns to the rank whose 2D net made it
    (``sharded_fusion_gather``);
  * the 3D net needs whole chunks: the fused features are re-split from
    (B_local, N/S) to (B_local/S, N) by a differentiable ``all_to_all``
    within the space group when B_local % S == 0, else all-gathered over
    the points, the 3D net run on every chunk and the logits cut back to
    the rank's points (``resplit``); ``local_share`` cuts the labels the
    same way, so every element of the global batch is scored on exactly one
    rank, and ``local_rows`` places the rank's chunks in the global batch
    for the head's dropout mask;
  * BatchNorm, the loss and the metrics sum over every rank (``dist.mesh``,
    ``models/blocks.BatchNorm``, ``train/metrics``).

``install_space_fusion(model, mesh)`` points the fusion model at a process
mesh; the step code is unchanged. Divisibility: N % space (asserted in
``sharded_fusion_gather``) and V % space (``shard_batch_sp`` and
``bootstrap.make_global_batch``).
"""
from __future__ import annotations

from mvpnet_torch.dist import bootstrap
from mvpnet_torch.dist.fusion import ring_knn_local
from mvpnet_torch.dist.mesh import DATA_AXIS, SPACE_AXIS

# batch keys whose axis 1 is the view axis, split over space
_VIEW_KEYS = ("images", "depth", "poses", "seg_label_2d")


def batch_specs(batch: dict) -> dict:
    """Axis names per batch key for space-sharded training: the batch dim
    over data, the view axis over space where present."""
    specs = {}
    for key, v in batch.items():
        ndim = getattr(v, "ndim", 0)
        if key in _VIEW_KEYS and ndim >= 2:
            specs[key] = (DATA_AXIS, SPACE_AXIS)
        elif ndim >= 1:
            specs[key] = (DATA_AXIS,)
        else:
            specs[key] = ()
    return specs


def shard_batch_sp(mesh, batch: dict) -> dict:
    """This rank's arrays of a global host batch under ``batch_specs``:
    the batch dim cut over data, the view axis over space."""
    out = {}
    for k, spec in batch_specs(batch).items():
        v = batch[k]
        for dim, axis in enumerate(spec):
            parts, index = (mesh.data, mesh.data_rank) if axis == DATA_AXIS else (mesh.space, mesh.space_rank)
            v = bootstrap.take(v, dim, index, parts)
        out[k] = v
    return out


def point_slice(mesh, x):
    """This rank's N/S points of each chunk of a (B, N, ...) tensor."""
    return bootstrap.take(x, 1, mesh.space_rank, mesh.space)


def local_share(mesh, x):
    """The part of a full-chunk (B_local, N, ...) tensor that this rank's
    3D net scores: B_local/S whole chunks after the all_to_all, else its
    N/S points of every chunk."""
    if x.shape[0] % mesh.space == 0:
        return bootstrap.take(x, 0, mesh.space_rank, mesh.space)
    return point_slice(mesh, x)


def local_rows(mesh, b_local: int) -> tuple[int, int]:
    """(first, total): where the chunks that this rank's 3D net runs sit in
    the global batch, for the head's dropout mask: the data rank holds
    ``b_local`` chunks; ``local_share`` keeps b_local/S of them after the
    all_to_all, and after the all-gather every space rank runs all of
    them."""
    first, total = mesh.data_rank * b_local, mesh.data * b_local
    if b_local % mesh.space:
        return first, total
    b = b_local // mesh.space
    return first + mesh.space_rank * b, total


def sharded_fusion_gather(mesh, points, pixel_xyz, pixel_feat, k: int):
    """Ring-fused kNN gather over the space group, for this rank's points.

    points (B, N, 3): the data rank's chunks, whole (replicated over space);
    pixel_xyz (B, P, 3) and pixel_feat (B, P, C): this rank's pixel block
    of each chunk (its V/S views). Returns (gxyz (B, N/S, k, 3), gfeat
    (B, N/S, k, C)) for this rank's ``point_slice``: each point's k nearest
    pixels over every space rank's block, as ``ops.knn`` +
    ``ops.group_points`` over the whole cloud gives them (up to which of two
    equal distances is kept). One batched ring for all B chunks,
    differentiable."""
    S = mesh.space
    if points.shape[1] % S:
        raise ValueError(f"chunk points {points.shape[1]} not divisible by space={S}")
    _, gxyz, gfeat = ring_knn_local(
        point_slice(mesh, points), pixel_xyz, pixel_feat, k=k, mesh=mesh, differentiable=True
    )
    return gxyz, gfeat


def resplit(mesh, points, fused):
    """The 3D net's inputs from the fused features of this rank's points.

    points (B, N, 3) whole chunks; fused (B, N/S, C'). B % S == 0: a
    differentiable all_to_all gives (points, fused) of chunks
    [s*B/S, (s+1)*B/S), all N points; else an all-gather over the points
    gives every chunk (the caller keeps its points of the logits,
    ``point_slice``)."""
    S = mesh.space
    B, n, c = fused.shape
    if B % S:
        return points, mesh.all_gather(fused, dim=1)
    b = B // S
    parts = mesh.all_to_all(fused.reshape(S, b, n, c))  # part t: space rank t's points of my chunks
    return local_share(mesh, points), parts.permute(1, 0, 2, 3).reshape(b, S * n, c)


def install_space_fusion(model, mesh):
    """Point the fusion model at a process mesh with a space axis: its
    forward routes the fusion kNN through ``sharded_fusion_gather`` and
    re-splits the 3D net's batch (``models/fusion.py``). Returns the
    model."""
    if not hasattr(model, "aggregation"):
        raise ValueError("space-sharded fusion expects the MVPNet3D fusion model")
    if mesh.loopback:
        raise ValueError("space-sharded training runs on a process mesh, not the loopback mesh")
    model.fusion_mesh = mesh
    return model
