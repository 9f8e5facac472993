"""Space-sharded multi-view kNN fusion: the ring exchange over a mesh.

Counterpart of ``mvpnet_tpu/dist/fusion.py``. Each space shard holds some
query points and one block of the pixel cloud (positions and features).
The ring runs S - 1 hops: at each hop every shard passes its current pixel
block to the next shard (``Mesh.rotate``: P2P in the space group, or a list
rotation on the loopback mesh) and folds the block it received into a
running per-point top-k. After the last hop every point has seen every
block, and no shard ever holds more than one block besides its own. The
result equals kNN over the concatenated cloud followed by the gathers, up to
which of two exactly equal distances is kept (``merge_topk``: the block seen
first wins, as in JAX's ring).

Each hop's search is one ``ops.knn`` call: the fusion kernel (row 1) for
blocks of >= 2^15 refs with >= 256 queries, the brute kernel (row 4)
otherwise.
"""
from __future__ import annotations

import torch

from mvpnet_torch import ops


def merge_topk(best, cand, k: int):
    """Merge two (d, xyz, feat) candidate sets along the neighbor axis,
    keeping the k smallest distances. Stable, with ``best`` first, so on
    equal distances ``best`` wins and, within a set, the earlier entry
    (``lax.top_k``'s order, ``mvpnet_tpu/dist/fusion.py:30-41``)."""
    d = torch.cat([best[0], cand[0]], dim=-1)  # (..., n, 2k)
    sel = torch.sort(d, dim=-1, stable=True).indices[..., :k]
    xyz = torch.cat([best[1], cand[1]], dim=-2)
    feat = torch.cat([best[2], cand[2]], dim=-2)
    return (
        torch.take_along_dim(d, sel, dim=-1),
        torch.take_along_dim(xyz, sel[..., None], dim=-2),
        torch.take_along_dim(feat, sel[..., None], dim=-2),
    )


def _local_knn(points, pixel_xyz, pixel_feat, k: int):
    d, idx = ops.knn(points, pixel_xyz, k)
    return d, ops.group_points(pixel_xyz, idx), ops.group_points(pixel_feat, idx)


def _ring(mesh, points: list, pixel_xyz: list, pixel_feat: list, k: int, differentiable: bool) -> list:
    """The ring body over the shards this process holds (lists, one entry
    for each of ``mesh.shards``), batched: points (B, n, 3), blocks
    (B, P, 3) and (B, P, C)."""
    best = [_local_knn(p, x, f, k) for p, x, f in zip(points, pixel_xyz, pixel_feat)]
    blocks = list(zip(pixel_xyz, pixel_feat))
    for _ in range(mesh.space - 1):
        blocks = mesh.rotate(blocks, differentiable)
        best = [merge_topk(b, _local_knn(p, x, f, k), k) for b, p, (x, f) in zip(best, points, blocks)]
    return best


def ring_knn_local(points, pixel_xyz, pixel_feat, *, k: int, mesh, differentiable: bool = False):
    """Each of this shard's points' k nearest pixels over every shard's
    block.

    On a process mesh: this rank's points (n, 3) or (B, n, 3) and its block
    (P, 3)/(P, C), or batched (B, P, ·); returns (d (…, n, k), xyz
    (…, n, k, 3), feat (…, n, k, C)). On the loopback mesh each argument is
    a list with one entry a shard and the result a list of those tuples.

    ``differentiable``: the hops' backward sends the gradient of the
    gathered features and positions back to the rank they came from (JAX
    unrolls its loop for the same reason); training needs it
    (``dist/train_sp.py``), inference does not."""
    if mesh.loopback:
        if not len(points) == len(pixel_xyz) == len(pixel_feat) == mesh.space:
            raise ValueError(f"loopback ring over {mesh.space} shards needs one entry a shard")
    else:
        points, pixel_xyz, pixel_feat = [points], [pixel_xyz], [pixel_feat]
    single = points[0].dim() == 2
    if single:  # one row: the batch dim of ops.knn
        points, pixel_xyz, pixel_feat = ([t[None] for t in ts] for ts in (points, pixel_xyz, pixel_feat))
    out = _ring(mesh, list(points), list(pixel_xyz), list(pixel_feat), k, differentiable)
    if single:
        out = [tuple(t[0] for t in shard) for shard in out]
    return out if mesh.loopback else out[0]


def sharded_fusion_knn(mesh, points, pixel_xyz, pixel_feat, k: int):
    """Distributed kNN fusion gather over the mesh's space axis.

    On a process mesh the arguments are this rank's shards, points (n, 3)
    and its pixel block (P, 3)/(P, C), and so is the result. On the loopback
    mesh they are the whole arrays (N, 3), (Ptot, 3), (Ptot, C), split into
    ``space`` equal shards here; the result is the whole (N, k), (N, k, 3),
    (N, k, C), in shard order."""
    if not mesh.loopback:
        return ring_knn_local(points, pixel_xyz, pixel_feat, k=k, mesh=mesh)
    S = mesh.space
    if points.shape[0] % S or pixel_xyz.shape[0] % S:
        raise ValueError(f"{points.shape[0]} points and {pixel_xyz.shape[0]} pixels not divisible by space={S}")
    out = ring_knn_local(
        list(points.chunk(S)), list(pixel_xyz.chunk(S)), list(pixel_feat.chunk(S)), k=k, mesh=mesh
    )
    return tuple(torch.cat(parts) for parts in zip(*out))
