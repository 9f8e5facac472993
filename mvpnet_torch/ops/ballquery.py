"""Fixed-K ball query: wrapper of the CUDA kernel ``csrc/ballquery.cu``.

Counterpart of ``mvpnet_tpu/ops/pallas/ballquery.py`` (``_bq_kernel``).
A CUDA tensor launches the kernel; a CPU tensor takes the plain version
(``reference.ball_query``). ``launches`` counts kernel launches.

The kernel serves ``centers_per_block`` centers with one block, which walks
the points in tiles of ``TILE``; ``tiled_emulation`` is its schedule in
plain PyTorch, for the tests.
"""
from __future__ import annotations

import numpy as np
import torch

from mvpnet_torch.ops import _cuda, reference

# csrc/ballquery.cu (kTile, kChunks' 32 points, kMaxCenters): points a tile,
# points a chunk (one warp ballot), the most centers a block serves
TILE = 1024
CHUNK = 32
MAX_CENTERS = 32
launches = 0
_sm_counts: dict[int, int] = {}


def centers_per_block(batch: int, centers: int, sms: int) -> int:
    """Centers one block serves when a batch of ``batch`` rows of
    ``centers`` centers runs on a card of ``sms`` SMs: as many as leave the
    grid about two blocks an SM (each block reads every point tile once for
    all its centers), at least 1 and at most MAX_CENTERS."""
    return max(1, min(MAX_CENTERS, batch * centers // (2 * sms)))


def _sms(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sm_counts[index]


def tiled_emulation(centers, points, radius: float, nsample: int, valid_mask=None, *, per_block: int, tile: int = TILE):
    """The kernel's schedule in plain PyTorch: each block of ``per_block``
    consecutive centers of a row walks the points in tiles of ``tile``, in
    index order; a tile's hits are counted a CHUNK at a time (one warp
    ballot each), a prefix over the chunks gives each hit its slot after the
    center's count, slots below K are kept, and the block stops after the
    first tile that leaves every one of its centers with K hits. An empty
    ball then takes the nearest point (lower index on ties). Returns idx (B,
    M, K) int32, count (B, M) int32 and the tiles the blocks scanned."""
    B, M, _ = centers.shape
    N = points.shape[1]
    K = nsample
    pts = reference.mask_points(points.float(), valid_mask)
    r2 = torch.tensor(np.float32(float(radius) ** 2))
    idx = torch.empty((B, M, K), dtype=torch.int32)
    count = torch.empty((B, M), dtype=torch.int32)
    tiles = 0
    for b in range(B):
        for m0 in range(0, M, per_block):
            c = centers[b, m0 : m0 + per_block].float()
            C = c.shape[0]
            cnt = torch.zeros(C, dtype=torch.long)
            first = torch.zeros(C, dtype=torch.long)
            slots = torch.zeros((C, K), dtype=torch.long)
            for base in range(0, N, tile):
                full = cnt >= K
                if full.all():
                    break
                tiles += 1
                j = torch.arange(base, base + tile)
                p = torch.full((tile, 3), float("inf"))  # past N: in no ball
                p[: min(tile, N - base)] = pts[b, base : base + tile]
                hit = (reference.sqdist(c, p) < r2) & ~full[:, None]  # (C, tile); a full center is skipped
                chunks = hit.reshape(C, -1, CHUNK)
                per_chunk = chunks.sum(-1)  # __popc of each chunk's ballot
                before = per_chunk.cumsum(-1) - per_chunk  # the prefix over chunks
                rank = chunks.cumsum(-1) - 1  # rank inside the chunk
                slot = (cnt[:, None, None] + before[..., None] + rank).reshape(C, tile)
                keep = hit & (slot < K)
                rows = torch.arange(C)[:, None].expand(C, tile)
                slots[rows[keep], slot[keep]] = j.expand(C, tile)[keep]
                total = per_chunk.sum(-1)
                found = (cnt == 0) & (total > 0)
                first[found] = torch.argmax(hit[found].to(torch.uint8), dim=-1) + base
                cnt += total
            empty = cnt == 0
            if empty.any():
                first[empty] = torch.argmin(reference.sqdist(c[empty], pts[b]), dim=-1)
            kept = cnt.clamp(max=K)
            filled = torch.arange(K)[None] < kept[:, None]
            idx[b, m0 : m0 + C] = torch.where(filled, slots, first[:, None]).to(torch.int32)
            count[b, m0 : m0 + C] = kept.to(torch.int32)
    return idx, count, tiles


def ball_query(centers: torch.Tensor, points: torch.Tensor, radius: float, nsample: int, valid_mask=None):
    """-> idx (B, M, K) int32, count (B, M) int32; see reference.ball_query."""
    global launches
    _cuda.check_xyz(centers, "centers")
    _cuda.check_xyz(points, "points", centers.shape[0])
    _cuda.same_device(centers, points)
    B, M, _ = centers.shape
    N = points.shape[1]
    if not 1 <= nsample <= N:
        raise ValueError(f"ball query needs 1 <= nsample <= points ({nsample}, {N})")
    if valid_mask is not None:
        if tuple(valid_mask.shape) != (B, N) or valid_mask.dtype != torch.bool:
            raise ValueError(f"valid_mask must be a ({B}, {N}) bool tensor")
        _cuda.same_device(points, valid_mask)
    if not centers.is_cuda:
        return reference.ball_query(centers, points, radius, nsample, valid_mask)
    c = centers.float().contiguous()
    p = reference.mask_points(points.float(), valid_mask).contiguous()
    idx = torch.empty((B, M, nsample), dtype=torch.int32, device=c.device)
    count = torch.empty((B, M), dtype=torch.int32, device=c.device)
    r2 = float(np.float32(float(radius) ** 2))
    per_block = centers_per_block(B, M, _sms(c.device))
    fn = _cuda.function("ballquery", "ball_query")
    _cuda.launch(
        fn, c.data_ptr(), p.data_ptr(), B, M, N, r2, nsample, per_block, idx.data_ptr(), count.data_ptr(), _cuda.stream(c)
    )
    launches += 1
    return idx, count
