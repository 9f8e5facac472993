"""Farthest point sampling: wrapper of the CUDA kernels of ``csrc/fps.cu``.

Counterpart of ``mvpnet_tpu/ops/pallas/fps.py``, whose two Pallas kernels
become two entry points of one source:
  * ``fps``, the row in one block's registers and shared memory
    (``_fps_batched_kernel``), laid out by ``block_layout``;
  * ``fps_perrow``, the row on a thread-block cluster (``_fps_kernel``), for
    rows too long for one block's shared memory (SA1 at the high-resolution
    config: 102,400 points). Each CTA of the cluster keeps a slice of the
    row in registers and shared memory (``cluster_split``).
``route`` picks between them from the row length and the card's shared
memory, as the TPU wrapper picks by VMEM, and ``farthest_point_sample``
calls the op of that name, ``mvpnet::fps`` or ``mvpnet::fps_perrow``
(``ops/_library.py``): a CUDA tensor launches the kernel (``launch``,
``launch_perrow``); a CPU tensor takes ``mvpnet::fps``'s plain version
(``reference.farthest_point_sample``). ``launches`` counts launches of
``fps`` and ``perrow.launches`` those of ``fps_perrow``.
"""
from __future__ import annotations

import ctypes
import types
from typing import NamedTuple

import torch

from mvpnet_torch.ops import _cuda

# bytes a point takes in the kernels' rows: float4 (x, y, z, dist)
ROW_BYTES = 16
# fps_shared_kernel (csrc/fps.cu kBlockPoints, kBlockThreads): the most
# points a thread keeps in registers (its template instances are the powers
# of two up to it) and the most threads a block takes; and the most threads
# a block takes for a row that they hold at BLOCK_POINTS a thread. On an H100
# 80GB HBM3 at 700 W (PERF.md), 512 threads x 16 points took 15% less than
# 1024 x 8 at 8192 points, and rows of 64 to 1024 points 6-25% less at one
# point a thread up to 256 threads than at 16 points a thread
BLOCK_POINTS = 16
BLOCK_THREADS = 512
SHORT_ROW_THREADS = 256
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


class BlockLayout(NamedTuple):
    """How ``fps`` lays a row over one block: each of ``threads`` threads
    keeps ``reg_points`` points in registers; the last ``shared`` points of
    the row keep their distances in shared memory only."""

    reg_points: int
    threads: int
    shared: int


def block_layout(n: int) -> BlockLayout:
    """The layout of a row of ``n`` points: a point a thread up to
    SHORT_ROW_THREADS threads (a whole number of warps), or BLOCK_THREADS
    for a row longer than SHORT_ROW_THREADS * BLOCK_POINTS; then the fewest
    points a thread (a power of two) that hold the row, or BLOCK_POINTS and
    the rest in shared memory."""
    most = SHORT_ROW_THREADS if n <= SHORT_ROW_THREADS * BLOCK_POINTS else BLOCK_THREADS
    t = min(most, 32 * max(1, -(-n // 32)))
    p = min(BLOCK_POINTS, 1 << (-(-n // t) - 1).bit_length())
    return BlockLayout(p, t, max(0, n - p * t))


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


def cluster_occupancy(n: int, device: torch.device) -> int:
    """Clusters of ``fps_perrow``'s kernel the card on ``device`` runs at
    once for rows of ``n`` points (``cudaOccupancyMaxActiveClusters``,
    csrc/fps.cu); a launch of more rows runs in waves."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    smem_points = cluster_split(n, shared_bytes(device))[1]
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        _cuda.launch(_cuda.function("fps", "fps_cluster_occupancy"), smem_points, ctypes.byref(out))
    return out.value


def farthest_point_sample(points: torch.Tensor, npoint: int, valid_mask=None):
    """(B, N, 3) -> (B, npoint) int32; see reference.farthest_point_sample."""
    _cuda.check_xyz(points, "points")
    B, N, _ = points.shape
    if npoint < 1 or N < 1:
        raise ValueError(f"fps needs npoint >= 1 and points, got npoint={npoint}, N={N}")
    if valid_mask is not None:
        if tuple(valid_mask.shape) != (B, N) or valid_mask.dtype != torch.bool:
            raise ValueError(f"valid_mask must be a ({B}, {N}) bool tensor")
        _cuda.same_device(points, valid_mask)
    kernel = route(N, shared_bytes(points.device)) if points.is_cuda else "fps"
    return getattr(torch.ops.mvpnet, kernel)(points, npoint, valid_mask)


def _operands(points, npoint: int, valid_mask):
    """The kernels' operands: f32 points, the mask as bytes (kept alive by
    the caller through the launch) and the output."""
    p = points.float().contiguous()
    mask = None if valid_mask is None else valid_mask.contiguous().view(torch.uint8)
    return p, mask, torch.empty((p.shape[0], npoint), dtype=torch.int32, device=p.device)


def launch(points: torch.Tensor, npoint: int, valid_mask=None):
    """The CUDA implementation of ``mvpnet::fps``: the row in one block,
    laid out by ``block_layout``."""
    global launches
    p, mask, out = _operands(points, npoint, valid_mask)
    mask_ptr = None if mask is None else mask.data_ptr()
    B, N, _ = p.shape
    layout = block_layout(N)
    _cuda.launch(_cuda.function("fps", "fps"), p.data_ptr(), mask_ptr, B, N, npoint, layout.reg_points,
                 layout.threads, out.data_ptr(), _cuda.stream(p))
    launches += 1
    return out


def launch_perrow(points: torch.Tensor, npoint: int, valid_mask=None):
    """The CUDA implementation of ``mvpnet::fps_perrow``: the row on a
    cluster, split by ``cluster_split``."""
    p, mask, out = _operands(points, npoint, valid_mask)
    mask_ptr = None if mask is None else mask.data_ptr()
    B, N, _ = p.shape
    slice_len, smem_points, slices = cluster_split(N, shared_bytes(p.device))
    scratch = None
    if any(s.overflow for s in slices):
        scratch = torch.empty((B, N, 4), dtype=torch.float32, device=p.device)
    _cuda.launch(
        _cuda.function("fps", "fps_perrow"), p.data_ptr(), mask_ptr, B, N, npoint, slice_len, smem_points,
        None if scratch is None else scratch.data_ptr(), out.data_ptr(), _cuda.stream(p),
    )
    perrow.launches += 1
    return out
