"""Farthest point sampling: wrapper of the CUDA kernel ``csrc/fps.cu``.

Counterpart of ``mvpnet_tpu/ops/pallas/fps.py`` (``_fps_batched_kernel``).
A CUDA tensor launches the kernel; a CPU tensor takes the plain version
(``reference.farthest_point_sample``). ``launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from mvpnet_torch.ops import _cuda, reference

launches = 0


def farthest_point_sample(points: torch.Tensor, npoint: int, valid_mask=None):
    """(B, N, 3) -> (B, npoint) int32; see reference.farthest_point_sample."""
    global launches
    _cuda.check_xyz(points, "points")
    B, N, _ = points.shape
    if npoint < 1 or N < 1:
        raise ValueError(f"fps needs npoint >= 1 and points, got npoint={npoint}, N={N}")
    if valid_mask is not None:
        if tuple(valid_mask.shape) != (B, N) or valid_mask.dtype != torch.bool:
            raise ValueError(f"valid_mask must be a ({B}, {N}) bool tensor")
        _cuda.same_device(points, valid_mask)
    if not points.is_cuda:
        return reference.farthest_point_sample(points, npoint, valid_mask)
    p = points.float().contiguous()
    mask_ptr = None
    if valid_mask is not None:
        mask = valid_mask.contiguous().view(torch.uint8)
        mask_ptr = mask.data_ptr()
    scratch = torch.empty((B, N), dtype=torch.float32, device=p.device)
    out = torch.empty((B, npoint), dtype=torch.int32, device=p.device)
    fn = _cuda.function("fps", "fps")
    _cuda.launch(fn, p.data_ptr(), mask_ptr, B, N, npoint, scratch.data_ptr(), out.data_ptr(), _cuda.stream(p))
    launches += 1
    return out
