"""Fusion-scale exact kNN: wrapper of the CUDA kernel ``csrc/knn_fusion.cu``.

Counterpart of ``mvpnet_tpu/ops/pallas/knn_bucketed.py`` (``_demand_kernel``):
the kNN of chunk points over a large pixel cloud. The CUDA version splits the
refs into slices searched by parallel blocks, then merges the slices' lists
(see the source). A CUDA tensor launches the kernel; a CPU tensor takes the
plain version (``reference.knn``). ``launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from mvpnet_torch.ops import _cuda, reference
from mvpnet_torch.ops.knn import check_args

# routing (ops.knn): ref clouds of at least MIN_N points with at least
# MIN_M queries take this kernel, as knn_bucketed.py:86-96 routes them
MIN_N = 1 << 15
MIN_M = 256
_BLOCK = 128  # queries per block, csrc/knn_fusion.cu kBlock
_MIN_SLICE = 1024  # refs per slice, at least one shared-memory tile
_BLOCKS_PER_SM = 8
launches = 0


def supported(M: int, N: int) -> bool:
    """Whether ops.knn routes an (M queries, N refs) search here."""
    return N >= MIN_N and M >= MIN_M


def slicing(B: int, M: int, N: int, num_sms: int) -> tuple[int, int]:
    """(slices, refs per slice): enough blocks for ~8 per SM, slices of at
    least one shared-memory tile."""
    q_tiles = -(-M // _BLOCK)
    want = -(-(_BLOCKS_PER_SM * num_sms) // (q_tiles * B))
    slices = max(1, min(want, -(-N // _MIN_SLICE)))
    slice_len = -(-N // slices)
    return slices, slice_len


def knn(queries: torch.Tensor, refs: torch.Tensor, k: int):
    """(B, M, 3), (B, N, 3) -> (B, M, k) f32 squared distances, ascending,
    and (B, M, k) int32 indices; ties go to the lower index."""
    global launches
    check_args(queries, refs, k)
    B, M, _ = queries.shape
    N = refs.shape[1]
    if not queries.is_cuda:
        return reference.knn(queries, refs, k)
    q = queries.float().contiguous()
    r = refs.float().contiguous()
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    slices, slice_len = slicing(B, M, N, sms)
    part_d = torch.empty((B, M, slices, k), dtype=torch.float32, device=q.device)
    part_i = torch.empty((B, M, slices, k), dtype=torch.int32, device=q.device)
    d = torch.empty((B, M, k), dtype=torch.float32, device=q.device)
    i = torch.empty((B, M, k), dtype=torch.int32, device=q.device)
    fn = _cuda.function("knn_fusion", "knn_fusion")
    _cuda.launch(
        fn, q.data_ptr(), r.data_ptr(), B, M, N, k, slices, slice_len,
        part_d.data_ptr(), part_i.data_ptr(), d.data_ptr(), i.data_ptr(), _cuda.stream(q),
    )
    launches += 1
    return d, i
