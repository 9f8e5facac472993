"""Gated fusion-scale exact kNN: wrapper of the CUDA kernel ``csrc/knn_gated.cu``.

Counterpart of ``mvpnet_tpu/ops/pallas/knn_bucketed.py::_knn_forward``
(``_gated_kernel``), which the JAX package runs for a fusion-size search when
``_USE_DEMAND`` is False; here ``ops.set_fusion_variant("gated")``. The
queries and refs are Morton-sorted and ranked by tile (``ops.morton``), the
kernel walks each query tile's ref tiles in ascending lower-bound order and
skips those that cannot improve any row, and the results are mapped back.
Ties between equal distances follow that visit order.

A CUDA tensor launches the kernel; a CPU tensor takes the plain version
(``morton.gated_plain``). ``launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from mvpnet_torch.ops import _cuda, morton
from mvpnet_torch.ops.knn import check_args

launches = 0


def tiles(M: int, N: int) -> tuple[int, int, bool]:
    """(tile_m, tile_n, sub_gate) of ``_knn_forward``'s policy: 256-row query
    tiles, 2048-ref tiles below 2^18 refs, 8192-ref tiles and the 8-row
    subgroup gate at and above."""
    big = N >= morton.BIG_N
    tile_m = min(morton.TILE_M, max(morton.SUB, M))
    return tile_m, (morton.TILE_N_BIG if big else morton.TILE_N), big


def plain(queries: torch.Tensor, refs: torch.Tensor, k: int, rows=None):
    """The kernel's plain version (``morton.gated_plain`` at this policy's tiles)."""
    tile_m, tile_n, _ = tiles(queries.shape[1], refs.shape[1])
    return morton.gated_plain(queries, refs, k, tile_m, tile_n, rows=rows)


def knn(queries: torch.Tensor, refs: torch.Tensor, k: int, scanned: torch.Tensor | None = None):
    """(B, M, 3), (B, N, 3) -> (B, M, k) f32 squared distances, ascending,
    and (B, M, k) int32 indices; ties follow the visit order. ``scanned``, an
    int64 CUDA tensor of one element, gets the (query, ref) pairs the kernel
    scanned added to it (the work its gate let through, for a bound)."""
    global launches
    check_args(queries, refs, k)
    if not queries.is_cuda:
        return plain(queries, refs, k)
    tile_m, tile_n, sub_gate = tiles(queries.shape[1], refs.shape[1])
    if sub_gate and tile_m % morton.SUB:
        raise ValueError(f"the subgroup gate needs query tiles of a multiple of {morton.SUB} rows, got {tile_m}")
    out = run_sorted("knn_gated", queries, refs, k, tile_m, tile_n, (int(sub_gate),), scanned)
    launches += 1
    return out


def run_sorted(kernel: str, queries, refs, k: int, tile_m: int, tile_n: int, flags: tuple, scanned):
    """Prepare (``morton.prepare``), launch ``kernel`` of ``csrc/<kernel>.cu``
    on the sorted operands (``flags`` go after ``k``) and map the result
    back to the original queries and refs. Shared with ``knn_resident``."""
    B, M, _ = queries.shape
    N = refs.shape[1]
    p = morton.prepare(queries, refs, tile_m, tile_n)
    M_pad, N_pad = p.q_sorted.shape[1], p.r_sorted.shape[1]
    d = torch.empty((B, M_pad, k), dtype=torch.float32, device=queries.device)
    i = torch.empty((B, M_pad, k), dtype=torch.int32, device=queries.device)
    _cuda.launch(
        _cuda.function(kernel, kernel),
        p.q_sorted.data_ptr(), p.r_sorted.data_ptr(), p.order.data_ptr(), p.lb_sorted.data_ptr(),
        B, M_pad, N_pad, tile_m, tile_n, k, *flags, d.data_ptr(), i.data_ptr(),
        None if scanned is None else _cuda.counter_ptr(scanned, queries), _cuda.stream(queries),
    )
    return morton.unmap(d, i, p.q_order, p.r_order, M, N)

