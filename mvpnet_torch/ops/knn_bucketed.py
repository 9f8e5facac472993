"""Fusion-scale exact kNN: wrapper of the CUDA kernel ``csrc/knn_fusion.cu``.

Counterpart of ``mvpnet_tpu/ops/pallas/knn_bucketed.py`` (``_demand_kernel``):
the kNN of chunk points over a large pixel cloud, ties to the lower ref
index. The kernel has two modes (see the source), and ``route`` picks one by
size:
  * ``"demand"``, the demand-gated search the TPU kernel does: queries and
    refs Morton-sorted and tiled (``morton.prepare_refs`` /
    ``prepare_queries``), each query tile walking its ref tiles in ascending
    bound order until the bound exceeds its worst k-th distance;
  * ``"brute"``, every pair, refs split into slices searched by parallel
    blocks, then the slices' lists merged: for searches too small for the
    sort and gate to pay.
``prepare`` / ``knn_prepared`` split the ref side off for a cloud queried
many times (``ops.knn_prepare``). ``knn`` and ``knn_prepared`` call the ops
``mvpnet::knn_fusion`` and ``mvpnet::knn_prepared`` (``ops/_library.py``),
the mode chosen before the op: a CUDA tensor launches the kernel
(``launch``, ``launch_prepared``; the demand mode's Morton prep runs inside),
a CPU tensor takes the plain version (``reference.knn``). ``launches``
counts kernel launches, of either mode.
"""
from __future__ import annotations

import torch

from mvpnet_torch.ops import _cuda, morton
from mvpnet_torch.ops.knn import check_args

# routing (ops.knn): ref clouds of at least MIN_N points with at least
# MIN_M queries take this kernel, as knn_bucketed.py:86-96 routes them
MIN_N = 1 << 15
MIN_M = 256
# searches of at least DEMAND_PAIRS (query, ref) pairs take the demand mode:
# on an H100 the brute mode wins at 3.8e9 pairs (the train shape), the two
# tie or the demand mode wins at 5.0e9, and the demand mode wins from 1.0e10
# up (chip_smoke.py's crossover shapes, PERF.md)
DEMAND_PAIRS = 1 << 32
_BLOCK = 128  # queries per block, csrc/knn_fusion.cu kBlock
_MIN_SLICE = 1024  # refs per slice, at least one shared-memory tile
_BLOCKS_PER_SM = 8
MODES = ("demand", "brute")
launches = 0


def supported(M: int, N: int) -> bool:
    """Whether ops.knn routes an (M queries, N refs) search here."""
    return N >= MIN_N and M >= MIN_M


def route(B: int, M: int, N: int) -> str:
    """The mode of a search of B rows of M queries over N refs."""
    return "demand" if B * M * N >= DEMAND_PAIRS else "brute"


def slicing(B: int, M: int, N: int, num_sms: int) -> tuple[int, int]:
    """(slices, refs per slice) of the brute mode: enough blocks for ~8 per
    SM, slices of at least one shared-memory tile."""
    q_tiles = -(-M // _BLOCK)
    want = -(-(_BLOCKS_PER_SM * num_sms) // (q_tiles * B))
    slices = max(1, min(want, -(-N // _MIN_SLICE)))
    slice_len = -(-N // slices)
    return slices, slice_len


def knn(queries: torch.Tensor, refs: torch.Tensor, k: int, mode: str | None = None, scanned=None):
    """(B, M, 3), (B, N, 3) -> (B, M, k) f32 squared distances, ascending,
    and (B, M, k) int32 indices; ties go to the lower index. ``mode``
    overrides ``route``; ``scanned``, an int64 CUDA tensor of one element,
    gets the (query, ref) pairs the kernel scanned added to it (every pair in
    the brute mode)."""
    check_args(queries, refs, k)
    B, M, _ = queries.shape
    N = refs.shape[1]
    mode = route(B, M, N) if mode is None else mode
    if mode not in MODES:
        raise ValueError(f"unknown fusion kNN mode {mode!r}; expected one of {MODES}")
    return torch.ops.mvpnet.knn_fusion(queries, refs, k, mode, scanned)


def launch(queries, refs, k: int, mode: str, scanned=None):
    """The CUDA implementation of ``mvpnet::knn_fusion`` in ``mode``."""
    if mode == "demand":
        # the quantization box of both sorts comes from the queries, as
        # _prepare's does
        q = queries.float()
        _, tile_n, _ = morton.demand_tiles(queries.shape[1], refs.shape[1])
        p = morton.prepare_refs(refs, tile_n, q.amin(dim=1, keepdim=True), q.amax(dim=1, keepdim=True))
        return launch_prepared(queries, p, k, scanned)
    if scanned is not None:
        scanned.add_(queries.shape[0] * queries.shape[1] * refs.shape[1])
    return _brute(queries, refs, k)


def _brute(queries, refs, k):
    global launches
    B, M, _ = queries.shape
    N = refs.shape[1]
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


def prepare(refs: torch.Tensor) -> morton.PreparedRefs:
    """The ref side of the demand mode, once for many ``knn_prepared`` calls
    (``prepare_refs``, knn_bucketed.py:887): Morton-sorted by the refs' own
    real box, tiled at the demand tiles of N refs."""
    _cuda.check_xyz(refs, "refs")
    N = refs.shape[1]
    return morton.prepare_refs(refs, morton.demand_tiles(1, N)[1])


def knn_prepared(queries: torch.Tensor, p: morton.PreparedRefs, k: int, scanned=None):
    """The demand mode against a prepared cloud: only the query side is
    prepared per call (``_knn_prepared_impl``, knn_bucketed.py:935); the
    contract of ``knn``."""
    check_args(queries, p.refs, k)
    _cuda.same_device(queries, p.r4)
    return torch.ops.mvpnet.knn_prepared(queries, p.r4, p.boxes, p.refs, p.n, p.tile_n, k, scanned)


def launch_prepared(queries: torch.Tensor, p: morton.PreparedRefs, k: int, scanned=None):
    """The CUDA implementation of ``mvpnet::knn_prepared``: the query side's
    prep, then the demand mode's kernel."""
    global launches
    B, M, _ = queries.shape
    N_pad = p.r4.shape[1]
    tile_m, _, sub_gate = morton.demand_tiles(M, p.n)
    q_sorted, q_order, order, lb = morton.prepare_queries(queries, p, tile_m)
    M_pad = q_sorted.shape[1]
    d = torch.empty((B, M_pad, k), dtype=torch.float32, device=queries.device)
    i = torch.empty((B, M_pad, k), dtype=torch.int32, device=queries.device)
    _cuda.launch(
        _cuda.function("knn_fusion", "knn_fusion_demand"),
        q_sorted.data_ptr(), p.r4.data_ptr(), order.data_ptr(), lb.data_ptr(), p.boxes.data_ptr(),
        B, M, M_pad, p.n, N_pad, tile_m, p.tile_n, k, int(sub_gate), d.data_ptr(), i.data_ptr(),
        None if scanned is None else _cuda.counter_ptr(scanned, queries), _cuda.stream(queries),
    )
    launches += 1
    inv = morton.inverse_perm(q_order)[..., None].expand(-1, -1, k)
    return torch.gather(d[:, :M], 1, inv), torch.gather(i[:, :M], 1, inv)
