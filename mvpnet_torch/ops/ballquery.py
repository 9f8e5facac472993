"""Fixed-K ball query: wrapper of the CUDA kernel ``csrc/ballquery.cu``.

Counterpart of ``mvpnet_tpu/ops/pallas/ballquery.py`` (``_bq_kernel``).
A CUDA tensor launches the kernel; a CPU tensor takes the plain version
(``reference.ball_query``). ``launches`` counts kernel launches.
"""
from __future__ import annotations

import numpy as np
import torch

from mvpnet_torch.ops import _cuda, reference

launches = 0


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
    fn = _cuda.function("ballquery", "ball_query")
    _cuda.launch(fn, c.data_ptr(), p.data_ptr(), B, M, N, r2, nsample, idx.data_ptr(), count.data_ptr(), _cuda.stream(c))
    launches += 1
    return idx, count
