"""Brute-force exact kNN: wrapper of the CUDA kernel ``csrc/knn.cu``.

Counterpart of ``mvpnet_tpu/ops/pallas/knn.py`` (``_knn_kernel``). A CUDA
tensor launches the kernel; a CPU tensor takes the plain version
(``reference.knn``). ``launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from mvpnet_torch.ops import _cuda, reference

MAX_K = 8
launches = 0


def check_args(queries: torch.Tensor, refs: torch.Tensor, k: int) -> None:
    """Raise unless queries (B, M, 3) and refs (B, N, 3) share a device and
    1 <= k <= min(MAX_K, N); the kNN kernels' common contract."""
    _cuda.check_xyz(queries, "queries")
    _cuda.check_xyz(refs, "refs", queries.shape[0])
    _cuda.same_device(queries, refs)
    N = refs.shape[1]
    if not 1 <= k <= min(MAX_K, N):
        raise ValueError(f"knn kernel needs 1 <= k <= min({MAX_K}, refs={N}), got k={k}")


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
    d = torch.empty((B, M, k), dtype=torch.float32, device=q.device)
    i = torch.empty((B, M, k), dtype=torch.int32, device=q.device)
    fn = _cuda.function("knn", "knn_brute")
    _cuda.launch(fn, q.data_ptr(), r.data_ptr(), B, M, N, k, d.data_ptr(), i.data_ptr(), _cuda.stream(q))
    launches += 1
    return d, i
