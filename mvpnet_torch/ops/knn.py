"""Brute-force exact kNN: wrapper of the CUDA kernel ``csrc/knn.cu``.

Counterpart of ``mvpnet_tpu/ops/pallas/knn.py`` (``_knn_kernel``). ``knn``
calls the op ``mvpnet::knn`` (``ops/_library.py``): a CUDA tensor launches
the kernel (``launch``), a CPU tensor takes the plain version
(``reference.knn``). ``launches`` counts kernel launches.

The kernel's schedule (lanes a query, queries a thread, refs a tile) comes
from ``layout``, by the shape and the card's SM count; ``split_emulation``
is that schedule in plain PyTorch, for the tests.
"""
from __future__ import annotations

import torch

from mvpnet_torch.ops import _cuda, reference

MAX_K = 8
# csrc/knn.cu: threads a block (kThreads), refs a tile at most (kMaxTile),
# refs a lane reads at once (a quad), the kernel's list lengths (K)
THREADS = 128
MAX_TILE = 1024
QUAD = 4
LIST_LENGTHS = (1, 2, 3, 4, 8)
MAX_LANES = 32
QUERIES_PER_THREAD = (2, 1)
# warps an SM that fill the card: with this fill, layout's lanes and queries
# a thread were the fastest (or within 3%) at every FP level of the three
# paths on an H100 (profile_levels.py's layout sweep, PERF.md)
FILL_WARPS = 8
launches = 0
_sm_counts: dict[int, int] = {}


def check_args(queries: torch.Tensor, refs: torch.Tensor, k: int) -> None:
    """Raise unless queries (B, M, 3) and refs (B, N, 3) share a device and
    1 <= k <= min(MAX_K, N); the kNN kernels' common contract."""
    _cuda.check_xyz(queries, "queries")
    _cuda.check_xyz(refs, "refs", queries.shape[0])
    _cuda.same_device(queries, refs)
    N = refs.shape[1]
    if not 1 <= k <= min(MAX_K, N):
        raise ValueError(f"knn kernel needs 1 <= k <= min({MAX_K}, refs={N}), got k={k}")


def layout(batch: int, queries: int, refs: int, sms: int) -> tuple[int, int, int]:
    """(lanes, queries_per_thread, tile) of a search of ``batch`` rows of
    ``queries`` queries over ``refs`` refs on a card of ``sms`` SMs, so that
    the grid fills the card (FILL_WARPS warps an SM). A thread takes 2
    queries (one quad read feeds more pairs) while that leaves four such
    fills, so the blocks spread evenly over the SMs; a query takes more
    lanes, in powers of two up to MAX_LANES, while the card is short of
    threads and each lane keeps two quads of a tile. A tile holds the row,
    up to MAX_TILE refs."""
    rows = batch * queries
    fill = sms * FILL_WARPS * 32
    per_thread = next(q for q in QUERIES_PER_THREAD if q == 1 or rows >= 4 * fill * q)
    tile = min(MAX_TILE, QUAD * -(-refs // QUAD))
    lanes = 1
    while lanes < MAX_LANES and 4 * lanes * QUAD <= tile and rows * lanes < fill * per_thread:
        lanes *= 2
    return lanes, per_thread, tile


def _sms(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sm_counts[index]


def knn_at(queries: torch.Tensor, refs: torch.Tensor, k: int, lanes: int, per_thread: int, tile: int):
    """The kernel at a given layout (``knn`` takes ``layout``'s), counted in
    ``launches``. CUDA tensors only."""
    global launches
    check_args(queries, refs, k)
    if not queries.is_cuda:
        raise ValueError("knn_at launches the kernel: it needs CUDA tensors")
    B, M, _ = queries.shape
    N = refs.shape[1]
    q = queries.float().contiguous()
    r = refs.float().contiguous()
    d = torch.empty((B, M, k), dtype=torch.float32, device=q.device)
    i = torch.empty((B, M, k), dtype=torch.int32, device=q.device)
    bulk = int(N % QUAD == 0 and r.data_ptr() % 16 == 0)  # cp.async.bulk needs 16-byte rows and tiles
    fn = _cuda.function("knn", "knn_brute")
    _cuda.launch(fn, q.data_ptr(), r.data_ptr(), B, M, N, k, lanes, per_thread, tile, bulk, d.data_ptr(),
                 i.data_ptr(), _cuda.stream(q))
    launches += 1
    return d, i


def knn(queries: torch.Tensor, refs: torch.Tensor, k: int):
    """(B, M, 3), (B, N, 3) -> (B, M, k) f32 squared distances, ascending,
    and (B, M, k) int32 indices; ties go to the lower index."""
    check_args(queries, refs, k)
    return torch.ops.mvpnet.knn(queries, refs, k)


def launch(queries: torch.Tensor, refs: torch.Tensor, k: int):
    """The CUDA implementation of ``mvpnet::knn``: the kernel at ``layout``'s
    layout for this shape and card."""
    B, M, _ = queries.shape
    return knn_at(queries, refs, k, *layout(B, M, refs.shape[1], _sms(queries.device)))


def split_emulation(queries: torch.Tensor, refs: torch.Tensor, k: int, lanes: int, tile: int = MAX_TILE):
    """The kernel's schedule in plain PyTorch. In each tile of ``tile`` refs
    (a multiple of QUAD), lane j of a query's ``lanes`` takes quads j, j +
    lanes, ... (QUAD consecutive refs; the row's last quad padded with +inf
    refs) and inserts each ref into its own list of K (k rounded up to a
    LIST_LENGTHS entry) with strict '<', in index order; the lanes' lists are
    then merged pairwise by the shuffle butterfly, each round the first K of
    the two lists in (distance, index) order. Returns the first k entries:
    (B, M, k) f32 distances and int32 indices. Queries a thread change no
    result and are not emulated."""
    B, M, _ = queries.shape
    N = refs.shape[1]
    K = next(n for n in LIST_LENGTHS if n >= k)
    d_all = reference.sqdist(queries, refs)  # (B, M, N): mvp_sqdist's order and rounding
    inf = torch.tensor(float("inf"))
    # each lane's columns, in its order of insertion (-1: a pad ref)
    cols = [[] for _ in range(lanes)]
    for base in range(0, N, tile):
        cnt = min(tile, N - base)
        for u in range(-(-cnt // QUAD)):
            cols[u % lanes] += [c if c < N else -1 for c in range(base + QUAD * u, base + QUAD * u + QUAD)]
    steps = max(len(c) for c in cols)
    col = torch.full((lanes, steps), -1, dtype=torch.long)
    for j, c in enumerate(cols):
        col[j, : len(c)] = torch.tensor(c, dtype=torch.long)
    bd = torch.full((B, M, lanes, K), float("inf"))
    bi = torch.full((B, M, lanes, K), 2**31 - 1, dtype=torch.long)
    slot = torch.arange(K)
    for s in range(steps):
        c = col[:, s]  # (lanes,)
        d = torch.where(c >= 0, d_all[..., c.clamp(min=0)], inf)  # (B, M, lanes)
        take = d < bd[..., -1]  # strict '<' with the K-th
        pos = (bd <= d[..., None]).sum(-1, keepdim=True)  # after every entry <= d: ties stay ahead
        shifted_d = torch.cat([bd[..., :1], bd[..., :-1]], -1)
        shifted_i = torch.cat([bi[..., :1], bi[..., :-1]], -1)
        new_d = torch.where(slot < pos, bd, torch.where(slot == pos, d[..., None], shifted_d))
        new_i = torch.where(slot < pos, bi, torch.where(slot == pos, c.expand(B, M, lanes)[..., None], shifted_i))
        bd = torch.where(take[..., None], new_d, bd)
        bi = torch.where(take[..., None], new_i, bi)
    off = 1
    while off < lanes:  # merge_lanes: lane j and lane j ^ off keep the first K of their union
        partner = torch.arange(lanes) ^ off
        ud = torch.cat([bd, bd[:, :, partner]], -1)
        ui = torch.cat([bi, bi[:, :, partner]], -1)
        order = torch.sort(ui, dim=-1, stable=True).indices  # (distance, index) order: index first,
        ud, ui = ud.gather(-1, order), ui.gather(-1, order)
        order = torch.sort(ud, dim=-1, stable=True).indices  # then a stable sort by distance
        bd, bi = ud.gather(-1, order)[..., :K], ui.gather(-1, order)[..., :K]
        off *= 2
    return bd[:, :, 0, :k].contiguous(), bi[:, :, 0, :k].to(torch.int32).contiguous()
