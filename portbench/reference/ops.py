"""Plain point-cloud ops of the reference, in float32.

Frozen from the port's plain versions (``mvpnet_torch/ops/reference.py``) as
the benchmark was written, with the same contracts: distances in the form
``(dx*dx + dy*dy) + dz*dz``, neighbours ordered by (distance, index), FPS
seeded at index 0 with the first maximum taken. Nothing here imports the
program.

The searches give the answer that ordering defines, however they reach it:
``knn`` orders the exact squared distances together with the index through
one integer key (the bits of a non-negative float32 keep its order), so a
tie goes to the lower index without a sort. A search over at least
``_PRUNED_REFS`` refs first bounds each query's k-th distance by its k-th
nearest among every ``_SUBSAMPLE``-th ref, then searches, for each block of
spatially sorted queries, only the refs inside the block's bounding box grown
by the block's largest bound: every ref as near as a query's k-th nearest
lies there, ties included, so the answer is the exhaustive one.
"""
from __future__ import annotations

import torch

# elements of a (rows, N) block materialized at once
_BLOCK_ELEMS = 1 << 26
# ref clouds at least this large take the pruned search (the fusion kNN)
_PRUNED_REFS = 1 << 15
_SUBSAMPLE = 16
_QUERY_BLOCK = 1024
_SORT_CELL = 0.25  # meters: the grid the queries are ordered by


def sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., M, 3) x (..., N, 3) -> (..., M, N) as (dx*dx + dy*dy) + dz*dz."""
    a = a.float()
    b = b.float()
    dx = a[..., :, None, 0] - b[..., None, :, 0]
    dy = a[..., :, None, 1] - b[..., None, :, 1]
    dz = a[..., :, None, 2] - b[..., None, :, 2]
    return (dx * dx + dy * dy) + dz * dz


def _row_blocks(M: int, per_row: int):
    step = max(1, _BLOCK_ELEMS // max(per_row, 1))
    for start in range(0, M, step):
        yield start, min(M, start + step)


def _key(d2: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """int64 keys ordered as (d2, idx) for d2 >= 0 and idx < 2^31."""
    return (d2.contiguous().view(torch.int32).to(torch.int64) << 32) | idx.to(torch.int64)


def _unkey(key: torch.Tensor):
    d2 = (key >> 32).to(torch.int32).view(torch.float32)
    return d2, (key & 0xFFFFFFFF).to(torch.int32)


def knn(queries, refs, k: int):
    """k nearest refs of each query: (B, M, k) squared distances, ascending,
    and (B, M, k) int32 indices; ties go to the lower index."""
    B, M, _ = queries.shape
    N = refs.shape[1]
    if not 1 <= k <= N:
        raise ValueError(f"knn needs 1 <= k <= refs ({k}, {N})")
    q, r = queries.float(), refs.float()
    d_out = torch.empty((B, M, k), dtype=torch.float32, device=q.device)
    i_out = torch.empty((B, M, k), dtype=torch.int32, device=q.device)
    for b in range(B):
        search = _pruned if N >= _PRUNED_REFS else _exhaustive
        d_out[b], i_out[b] = search(q[b], r[b], k)
    return d_out, i_out


def _exhaustive(q, r, k, ids=None):
    """(M, 3) x (N, 3) -> the k nearest by (squared distance, index); ``ids``
    gives the refs' indices (default 0..N-1)."""
    ids = torch.arange(len(r), device=q.device) if ids is None else ids
    d_out = torch.empty((len(q), k), dtype=torch.float32, device=q.device)
    i_out = torch.empty((len(q), k), dtype=torch.int32, device=q.device)
    for s, e in _row_blocks(len(q), len(r)):
        top = torch.topk(_key(sqdist(q[s:e], r), ids.expand(e - s, -1)), k, dim=-1, largest=False).values
        d_out[s:e], i_out[s:e] = _unkey(top)
    return d_out, i_out


def _pruned(q, r, k):
    sub = torch.arange(0, len(r), _SUBSAMPLE, device=q.device)
    bound = torch.empty(len(q), device=q.device)
    for s, e in _row_blocks(len(q), len(sub)):
        bound[s:e] = torch.topk(sqdist(q[s:e], r[sub]), k, dim=-1, largest=False).values[:, -1]
    cell = torch.floor(q / _SORT_CELL).to(torch.int64)
    cell -= cell.min(dim=0).values
    span = cell.max() + 1
    order = torch.argsort((cell[:, 0] * span + cell[:, 1]) * span + cell[:, 2])
    d_out = torch.empty((len(q), k), dtype=torch.float32, device=q.device)
    i_out = torch.empty((len(q), k), dtype=torch.int32, device=q.device)
    for s in range(0, len(q), _QUERY_BLOCK):
        rows = order[s : s + _QUERY_BLOCK]
        qb = q[rows]
        # grown a little past the bound's square root, so rounding keeps a
        # ref at exactly the bound inside
        grow = torch.sqrt(bound[rows].max()) * (1 + 1e-5) + 1e-6
        inside = ((r >= qb.min(dim=0).values - grow) & (r <= qb.max(dim=0).values + grow)).all(dim=1)
        ids = torch.nonzero(inside)[:, 0]
        d_out[rows], i_out[rows] = _exhaustive(qb, r[ids], k, ids)
    return d_out, i_out


def farthest_point_sample(points, npoint: int):
    """(B, N, 3) -> (B, npoint) int64 indices maximizing the min distance,
    seeded at index 0; argmax takes the first occurrence."""
    B, N, _ = points.shape
    pts = points.float()
    dist = torch.full((B, N), float("inf"), device=pts.device)
    last = torch.zeros(B, dtype=torch.long, device=pts.device)
    out = torch.empty((B, npoint), dtype=torch.long, device=pts.device)
    out[:, 0] = last
    rows = torch.arange(B, device=pts.device)
    for i in range(1, npoint):
        lx = pts[rows, last]
        dx = pts[..., 0] - lx[:, None, 0]
        dy = pts[..., 1] - lx[:, None, 1]
        dz = pts[..., 2] - lx[:, None, 2]
        dist = torch.minimum(dist, (dx * dx + dy * dy) + dz * dz)
        last = torch.argmax(dist, dim=1)
        out[:, i] = last
    return out


def ball_query(centers, points, radius: float, nsample: int):
    """First ``nsample`` points within ``radius`` of each center, in index
    order, padded with the first hit; an empty ball takes the nearest point
    (lower index on ties). ``radius**2`` is rounded to float32 once."""
    B, M, _ = centers.shape
    N = points.shape[1]
    r2 = torch.tensor(float(radius) ** 2, dtype=torch.float32, device=centers.device)
    idx = torch.empty((B, M, nsample), dtype=torch.int64, device=centers.device)
    j = torch.arange(N, device=centers.device)
    for s, e in _row_blocks(M, N * B):
        d2 = sqdist(centers[:, s:e], points)
        key = torch.where(d2 < r2, N - j, -1)
        topv, topi = torch.topk(key, nsample, dim=-1)
        hit = topv > 0
        nearest = torch.argmin(d2, dim=-1, keepdim=True)
        first = torch.where(hit[..., :1], topi[..., :1], nearest)
        idx[:, s:e] = torch.where(hit, topi, first)
    return idx


def group_points(features, idx):
    """(B, N, C) gathered by (B, M, K) -> (B, M, K, C)."""
    B, M, K = idx.shape
    C = features.shape[-1]
    flat = idx.reshape(B, M * K, 1).long().expand(B, M * K, C)
    return torch.gather(features, 1, flat).reshape(B, M, K, C)


def gather_points(xyz, idx):
    """(B, N, C) rows picked by (B, M) indices -> (B, M, C)."""
    return torch.gather(xyz, 1, idx.long()[..., None].expand(-1, -1, xyz.shape[-1]))


def three_nn_interpolate(dense_xyz, sparse_xyz, sparse_feat, eps: float = 1e-8):
    """Inverse-squared-distance weighted sum of the 3 nearest sparse points'
    features: (B, S, C) -> (B, N, C)."""
    d2, idx = knn(dense_xyz, sparse_xyz, 3)
    w = 1.0 / (d2 + eps)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    neigh = group_points(sparse_feat, idx)
    return torch.sum(neigh * w[..., None].to(neigh.dtype), dim=2)


def nearest(queries, refs):
    """Index of each query's nearest ref, (M,) int64, lower index on ties;
    (M, 3) and (N, 3) point sets."""
    _, idx = knn(queries[None], refs[None], 1)
    return idx[0, :, 0].long()
