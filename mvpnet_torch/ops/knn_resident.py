"""Resident-cloud fusion-scale exact kNN: wrapper of ``csrc/knn_resident.cu``.

Counterpart of ``mvpnet_tpu/ops/pallas/knn_bucketed.py::_knn_forward_demand``
with ``use_vmem=True`` (``_vmem_kernel``); here
``ops.set_fusion_variant("resident")``. Same prep as the gated kernel
(``morton.prepare_device``) with 64-row query tiles and 1024-ref tiles, and
the same search body (``csrc/common.cuh``'s ``gated_search``); each query
tile walks its ref tiles in ascending lower-bound order and stops at the
first bound that cannot beat its worst k-th distance, the first tile
included. It takes at most 2^17 refs and raises above that, as the JAX
package does.

``knn`` calls the op ``mvpnet::knn_resident`` (``ops/_library.py``): a
CUDA tensor launches the kernels (``launch``); a CPU tensor takes the plain
version (``morton.gated_plain``). ``launches`` counts search-kernel
launches.
"""
from __future__ import annotations

import torch

from mvpnet_torch.ops import morton
from mvpnet_torch.ops.knn import _sms, check_args
from mvpnet_torch.ops.knn_gated import layout, run

launches = 0


def tiles(M: int) -> tuple[int, int]:
    """(tile_m, tile_n) of ``_knn_forward_demand(use_vmem=True)``."""
    return min(morton.VMEM_TILE_M, max(morton.SUB, M)), morton.VMEM_TILE_N


def check_size(N: int) -> None:
    if N > morton.VMEM_N_MAX:
        raise ValueError(f"the resident kNN keeps the whole ref cloud resident: N={N} > {morton.VMEM_N_MAX}")


def plain(queries: torch.Tensor, refs: torch.Tensor, k: int, rows=None, sort_refs: bool = True):
    """The kernel's plain version (``morton.gated_plain`` at these tiles)."""
    check_size(refs.shape[1])
    tile_m, tile_n = tiles(queries.shape[1])
    return morton.gated_plain(queries, refs, k, tile_m, tile_n, rows=rows, sort_refs=sort_refs)


def knn(queries: torch.Tensor, refs: torch.Tensor, k: int, scanned: torch.Tensor | None = None,
        sort_refs: bool = True):
    """(B, M, 3), (B, N <= 2^17, 3) -> (B, M, k) f32 squared distances,
    ascending, and (B, M, k) int32 indices; ties follow the visit order.
    ``scanned`` and ``sort_refs``: as ``knn_gated.knn``'s."""
    check_args(queries, refs, k)
    check_size(refs.shape[1])
    return torch.ops.mvpnet.knn_resident(queries, refs, k, sort_refs, scanned)


def launch(queries, refs, k: int, sort_refs: bool = True, scanned=None):
    """The CUDA implementation of ``mvpnet::knn_resident``: the prep and the
    kernel at ``layout``'s layout for this shape and card."""
    B, M, _ = queries.shape
    return knn_at(queries, refs, k, *layout(B, M, *tiles(M), _sms(queries.device)), scanned, sort_refs)


def knn_at(queries, refs, k: int, lanes: int, rows: int, scanned=None, sort_refs: bool = True):
    """The prep and the kernel at a given layout, counted in ``launches``.
    CUDA tensors only."""
    global launches
    check_size(refs.shape[1])
    tile_m, tile_n = tiles(queries.shape[1])
    out = run("knn_resident", queries, refs, k, tile_m, tile_n, lanes, rows, scanned, sort_refs)
    launches += 1
    return out
