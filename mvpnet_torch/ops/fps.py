"""Farthest point sampling: wrapper of the CUDA kernels of ``csrc/fps.cu``.

Counterpart of ``mvpnet_tpu/ops/pallas/fps.py``, whose two Pallas kernels
become two entry points of one source:
  * ``fps``, the row in shared memory (``_fps_batched_kernel``);
  * ``fps_perrow``, the row in device memory (``_fps_kernel``), for rows too
    long for a block's shared memory (SA1 at the high-resolution config:
    102,400 points).
``route`` picks between them from the row length and the card's shared
memory, as the TPU wrapper picks by VMEM. A CUDA tensor launches a kernel; a
CPU tensor takes the plain version (``reference.farthest_point_sample``).
``launches`` counts launches of ``fps`` and ``perrow.launches`` those of
``fps_perrow``.
"""
from __future__ import annotations

import ctypes
import types

import torch

from mvpnet_torch.ops import _cuda, reference

# bytes a point takes in the kernels' rows: float4 (x, y, z, dist)
ROW_BYTES = 16
launches = 0
perrow = types.SimpleNamespace(launches=0)  # ops.KERNELS["fps_perrow"]
_shared_bytes: dict[int, int] = {}


def route(n: int, shared_bytes: int) -> str:
    """The kernel for rows of ``n`` points when a block may take
    ``shared_bytes`` of dynamic shared memory: ``"fps"`` when the row fits
    there, else ``"fps_perrow"``."""
    return "fps" if ROW_BYTES * n <= shared_bytes else "fps_perrow"


def shared_bytes(device: torch.device) -> int:
    """Dynamic shared memory a block of the shared-memory kernel may take on
    ``device`` (the opt-in limit less its static shared memory)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _shared_bytes:
        out = ctypes.c_int(0)
        with torch.cuda.device(index):
            _cuda.launch(_cuda.function("fps", "fps_shared_bytes"), ctypes.byref(out))
        _shared_bytes[index] = out.value
    return _shared_bytes[index]


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
    out = torch.empty((B, npoint), dtype=torch.int32, device=p.device)
    stream = _cuda.stream(p)
    if route(N, shared_bytes(p.device)) == "fps":
        fn = _cuda.function("fps", "fps")
        _cuda.launch(fn, p.data_ptr(), mask_ptr, B, N, npoint, out.data_ptr(), stream)
        launches += 1
    else:
        scratch = torch.empty((B, N, 4), dtype=torch.float32, device=p.device)
        fn = _cuda.function("fps", "fps_perrow")
        _cuda.launch(fn, p.data_ptr(), mask_ptr, B, N, npoint, scratch.data_ptr(), out.data_ptr(), stream)
        perrow.launches += 1
    return out
