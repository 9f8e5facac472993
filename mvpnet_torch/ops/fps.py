"""Farthest point sampling: wrapper of the CUDA kernels of ``csrc/fps.cu``.

Counterpart of ``mvpnet_tpu/ops/pallas/fps.py``, whose two Pallas kernels
become two entry points of one source:
  * ``fps``, the row in one block's shared memory (``_fps_batched_kernel``);
  * ``fps_perrow``, the row on a thread-block cluster (``_fps_kernel``), for
    rows too long for one block's shared memory (SA1 at the high-resolution
    config: 102,400 points). Each CTA of the cluster keeps a slice of the
    row in registers and shared memory (``cluster_split``).
``route`` picks between them from the row length and the card's shared
memory, as the TPU wrapper picks by VMEM. A CUDA tensor launches a kernel; a
CPU tensor takes the plain version (``reference.farthest_point_sample``).
``launches`` counts launches of ``fps`` and ``perrow.launches`` those of
``fps_perrow``.
"""
from __future__ import annotations

import ctypes
import types
from typing import NamedTuple

import torch

from mvpnet_torch.ops import _cuda, reference

# bytes a point takes in the kernels' rows: float4 (x, y, z, dist)
ROW_BYTES = 16
# fps_cluster_kernel (csrc/fps.cu kCluster, kClusterThreads, kRegPoints):
# CTAs of the cluster that samples one row (a non-portable cluster size; 8
# took longer on the H100, PERF.md), threads a CTA and points a thread keeps
# in registers
CLUSTER = 16
CLUSTER_THREADS = 512
REG_POINTS = 14
launches = 0
perrow = types.SimpleNamespace(launches=0)  # ops.KERNELS["fps_perrow"]
_shared_bytes: dict[int, int] = {}


def route(n: int, shared_bytes: int) -> str:
    """The kernel for rows of ``n`` points when a block may take
    ``shared_bytes`` of dynamic shared memory: ``"fps"`` when the row fits
    there, else ``"fps_perrow"``."""
    return "fps" if ROW_BYTES * n <= shared_bytes else "fps_perrow"


class Slice(NamedTuple):
    """One CTA's part of a row in ``fps_perrow``: points [start, stop), of
    which the first ``regs`` live in registers, the next ``shared`` in shared
    memory and the last ``overflow`` in the device-memory scratch."""

    start: int
    stop: int
    regs: int
    shared: int
    overflow: int


def cluster_split(n: int, shared_bytes: int) -> tuple[int, int, list[Slice]]:
    """How ``fps_perrow`` lays a row of ``n`` points over a cluster of
    ``CLUSTER`` CTAs that may each take ``shared_bytes`` of dynamic shared
    memory: (slice length, shared-memory points a CTA, the CTAs' slices).
    The kernel computes the same split from the first two."""
    slice_len = -(-n // CLUSTER)
    on_regs = REG_POINTS * CLUSTER_THREADS
    smem_points = min(max(slice_len - on_regs, 0), shared_bytes // ROW_BYTES)
    slices = []
    for rank in range(CLUSTER):
        start = min(n, rank * slice_len)
        stop = min(n, start + slice_len)
        regs = min(stop - start, on_regs)
        shared = min(stop - start - regs, smem_points)
        slices.append(Slice(start, stop, regs, shared, stop - start - regs - shared))
    return slice_len, smem_points, slices


def shared_bytes(device: torch.device) -> int:
    """Dynamic shared memory a block of either kernel may take on
    ``device`` (the opt-in limit less their static shared memory)."""
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
    avail = shared_bytes(p.device)
    if route(N, avail) == "fps":
        fn = _cuda.function("fps", "fps")
        _cuda.launch(fn, p.data_ptr(), mask_ptr, B, N, npoint, out.data_ptr(), stream)
        launches += 1
    else:
        slice_len, smem_points, slices = cluster_split(N, avail)
        scratch = None
        if any(s.overflow for s in slices):
            scratch = torch.empty((B, N, 4), dtype=torch.float32, device=p.device)
        fn = _cuda.function("fps", "fps_perrow")
        _cuda.launch(
            fn, p.data_ptr(), mask_ptr, B, N, npoint, slice_len, smem_points,
            None if scratch is None else scratch.data_ptr(), out.data_ptr(), stream,
        )
        perrow.launches += 1
    return out
