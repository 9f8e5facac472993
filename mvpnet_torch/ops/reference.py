"""Plain PyTorch versions of the point-cloud ops.

Counterparts of ``mvpnet_tpu/ops/reference.py`` with the same channels-last
contracts. They are what the dispatch (``mvpnet_torch/ops/__init__.py``)
runs for a CPU tensor, and what ``chip_smoke.py`` holds each CUDA kernel
against on the card.

Distances use the kernels' exact form, ``(dx*dx + dy*dy) + dz*dz`` in f32,
written out one elementwise op at a time so the rounding is fixed: eager
PyTorch neither reorders nor fuses them, and the kernels spell the same
order with ``__fmul_rn``/``__fadd_rn``. Kernel and plain version therefore
agree bit for bit on the card. (The JAX reference uses the
``|a|^2 - 2ab + |b|^2`` expansion, so against it distances agree to ~1e-6.)

Ties: ``knn`` orders by (distance, index) through a stable sort — never
``torch.topk``, whose tie order is unspecified — and ``argmax``/``argmin``
return the first occurrence, as ``jnp.argmax`` does.

Masked refs/points are moved to a far sentinel (1e9), as the Pallas wrappers
do (``ops/pallas/knn.py:207``, ``ops/pallas/ballquery.py:127``): they stay
finite, so a masked point is returned only when fewer than ``k`` valid ones
exist.
"""
from __future__ import annotations

import torch

MASK_COORD = 1e9
# rows of a (rows, N) distance block materialized at once by the plain
# versions: 2^26 f32 = 256 MB (the fusion kNN's full 8192 x 96000 matrix
# would be 3.1 GB)
_BLOCK_ELEMS = 1 << 26


def sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., M, 3) x (..., N, 3) -> (..., M, N) f32 as (dx*dx + dy*dy) + dz*dz."""
    a = a.float()
    b = b.float()
    dx = a[..., :, None, 0] - b[..., None, :, 0]
    dy = a[..., :, None, 1] - b[..., None, :, 1]
    dz = a[..., :, None, 2] - b[..., None, :, 2]
    return (dx * dx + dy * dy) + dz * dz


def mask_points(points: torch.Tensor, valid_mask) -> torch.Tensor:
    """Move invalid points to the 1e9 sentinel (None: unchanged)."""
    if valid_mask is None:
        return points
    return torch.where(valid_mask[..., None], points, points.new_tensor(MASK_COORD))


def _row_blocks(M: int, N: int):
    step = max(1, _BLOCK_ELEMS // max(N, 1))
    for start in range(0, M, step):
        yield start, min(M, start + step)


def farthest_point_sample(points, npoint: int, valid_mask=None):
    """(B, N, 3) -> (B, npoint) int32 indices maximizing the min distance.

    Seeded at the first valid index (0 when unmasked); argmax takes the first
    occurrence; invalid points are held at -inf and never selected while a
    valid point remains."""
    B, N, _ = points.shape
    pts = points.float()
    if valid_mask is None:
        dist = torch.full((B, N), float("inf"), device=pts.device)
        last = torch.zeros(B, dtype=torch.long, device=pts.device)
    else:
        dist = torch.where(valid_mask, float("inf"), float("-inf")).to(pts.device)
        last = torch.argmax(valid_mask.to(torch.uint8), dim=1)
    out = torch.empty((B, npoint), dtype=torch.long, device=pts.device)
    out[:, 0] = last
    rows = torch.arange(B, device=pts.device)
    for i in range(1, npoint):
        lx = pts[rows, last]  # (B, 3)
        dx = pts[..., 0] - lx[:, None, 0]
        dy = pts[..., 1] - lx[:, None, 1]
        dz = pts[..., 2] - lx[:, None, 2]
        dist = torch.minimum(dist, (dx * dx + dy * dy) + dz * dz)
        last = torch.argmax(dist, dim=1)
        out[:, i] = last
    return out.to(torch.int32)


def ball_query(centers, points, radius: float, nsample: int, valid_mask=None):
    """First ``nsample`` points within ``radius`` of each center, in index order.

    Returns idx (B, M, K) int32 padded with the first hit (an empty ball
    falls back to the nearest point, lower index on ties) and count (B, M)
    int32 = min(hits, K). ``radius**2`` is rounded to f32 once, as
    ``ops/pallas/ballquery.py:140`` does."""
    B, M, _ = centers.shape
    N = points.shape[1]
    if not 1 <= nsample <= N:
        raise ValueError(f"ball query needs 1 <= nsample <= points ({nsample}, {N})")
    pts = mask_points(points, valid_mask)
    r2 = torch.tensor(float(radius) ** 2, dtype=torch.float32)
    idx = torch.empty((B, M, nsample), dtype=torch.int32, device=centers.device)
    count = torch.empty((B, M), dtype=torch.int32, device=centers.device)
    j = torch.arange(N, device=centers.device)
    for s, e in _row_blocks(M, N):
        d2 = sqdist(centers[:, s:e], pts)  # (B, m, N)
        in_ball = d2 < r2.to(d2.device)
        # key N - j for hits (earliest index = largest key), -1 for misses:
        # hit keys are distinct, so the top K are exactly the first K hits
        key = torch.where(in_ball, N - j, -1)
        topv, topi = torch.topk(key, nsample, dim=-1)
        hit = topv > 0
        cnt = hit.sum(-1)
        nearest = torch.argmin(d2, dim=-1, keepdim=True)
        first = torch.where(cnt[..., None] > 0, topi[..., :1], nearest)
        idx[:, s:e] = torch.where(hit, topi, first).to(torch.int32)
        count[:, s:e] = cnt.to(torch.int32)
    return idx, count


def group_points(features, idx):
    """(B, N, C) gathered by (B, M, K) -> (B, M, K, C).

    The kernels write int32 indices, as the Pallas kernels do; ``torch.gather``
    takes int64 only, so they are widened here."""
    B, M, K = idx.shape
    C = features.shape[-1]
    flat = idx.reshape(B, M * K, 1).long().expand(B, M * K, C)
    return torch.gather(features, 1, flat).reshape(B, M, K, C)


def knn(queries, refs, k: int, ref_mask=None):
    """k nearest refs of each query: (B, M, k) f32 squared distances,
    ascending, and (B, M, k) int32 indices; ties go to the lower index."""
    B, M, _ = queries.shape
    N = refs.shape[1]
    if not 1 <= k <= N:
        raise ValueError(f"knn needs 1 <= k <= refs ({k}, {N})")
    r = mask_points(refs, ref_mask)
    d_out = torch.empty((B, M, k), dtype=torch.float32, device=queries.device)
    i_out = torch.empty((B, M, k), dtype=torch.int32, device=queries.device)
    for s, e in _row_blocks(M, N):
        d2 = sqdist(queries[:, s:e], r)
        d_sorted, i_sorted = torch.sort(d2, dim=-1, stable=True)
        d_out[:, s:e] = d_sorted[..., :k]
        i_out[:, s:e] = i_sorted[..., :k].to(torch.int32)
    return d_out, i_out


def interpolate(d2, idx, sparse_feat, eps: float = 1e-8):
    """Inverse-squared-distance weighted sum of the gathered 3-NN features."""
    w = 1.0 / (d2 + eps)
    w = w / torch.sum(w, dim=-1, keepdim=True)  # (B, N, 3)
    neigh = group_points(sparse_feat, idx)  # (B, N, 3, C)
    return torch.sum(neigh * w[..., None].to(neigh.dtype), dim=2)


def three_nn_interpolate(dense_xyz, sparse_xyz, sparse_feat, eps: float = 1e-8):
    """Inverse-distance-weighted 3-NN upsampling (B, S, C) -> (B, N, C)."""
    d2, idx = knn(dense_xyz, sparse_xyz, 3)
    return interpolate(d2, idx, sparse_feat, eps)
