"""Morton sort and tile lower bounds of the gated fusion kNN.

Counterpart of the jnp preparation in ``mvpnet_tpu/ops/pallas/knn_bucketed.py``
(``_morton_code`` :99, ``_tile_bounds`` :116, ``_box_sqdist`` :130,
``_prepare`` :693, ``_inverse_perm`` :600, ``_unmap`` :610) with its
constants (:58-83), in plain PyTorch on the tensor's device; and its CUDA
counterpart ``prepare_device`` (``csrc/morton.cu``), whose output the gated
kernels (``csrc/knn_gated.cu``, ``csrc/knn_resident.cu``) take. The demand
mode of the fusion kNN (``csrc/knn_fusion.cu``) takes ``prepare_refs``'s
output (``prepare_refs`` :887, the ref side, once per cloud) and
``prepare_queries``'s (``_knn_prepared_impl`` :935, the query side), which
also bound each ref tile's sentinel refs.

  1. Queries and refs are sorted by a 30-bit Morton code over the queries'
     bounding box, so consecutive slabs are spatially compact.
  2. Both are padded to whole tiles with the 3e9 pad coordinate.
  3. Each (query tile, ref tile) pair gets the squared distance between
     their boxes over real coordinates (|c| < 1e5) as a lower bound; each
     query tile visits the ref tiles in ascending bound order.

Both sorts are stable (``argsort(stable=True)``), as ``jnp.argsort`` is:
equal Morton codes and the lb = 0 ties of overlapping boxes are common, and
the visit order must be the JAX package's exactly. With ``sort_refs=False``
(``ops.knn``'s ``refs_coherent``) the refs keep their order, as ``_prepare``
does then.

``prepare`` and ``unmap`` are the plain chain. On the card the gated kernels
take ``prepare_device``'s operands instead: the same prep in the kernels of
``csrc/morton.cu`` (query box, Morton codes, one stable radix sort of both
sides' codes, the gather with the tile boxes, the bounds with each query
tile's stable visit order), with each sorted point's original index in
its 4th coordinate, so that the search kernel writes the original order
itself and no ``unmap`` runs.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mvpnet_torch.ops import _cuda

TILE_M = 256
TILE_N = 2048
TILE_N_BIG = 8192  # ref tiles at and above BIG_N (the subgroup-gated body)
BIG_N = 1 << 18
SUB = 8  # query rows per gated subgroup
MAX_K = 8
# ref padding: beyond the 1e9 masked-ref sentinel, so padding never outranks
# a masked but real ref; (3e9)^2 * 3 < f32 max
PAD_COORD = 3e9
# coordinates at or above this magnitude are sentinels (invalid-pixel fill
# 1e6, masked ref 1e9, pad 3e9): excluded from the tile boxes
SENTINEL_MIN = 1e5
# the resident variant (csrc/knn_resident.cu): the whole sorted cloud stays
# resident, so it takes at most VMEM_N_MAX refs
VMEM_N_MAX = 1 << 17
VMEM_TILE_M = 64
VMEM_TILE_N = 1024
# the demand-gated fusion kNN (csrc/knn_fusion.cu, knn_bucketed.py:65-71):
# query tiles of 128 rows and ref tiles of 4096 from BIG_N refs up, 64 and
# TILE_N below
DEMAND_TILE_M = 128
DEMAND_TILE_M_SMALL = 64
DEMAND_TILE_N_BIG = 4096


def morton_code(xyz: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """30-bit Morton code from 10 bits a dimension; xyz (..., 3), lo/hi (..., 1, 3)."""
    scale = torch.clamp(hi - lo, min=1e-12)
    q = torch.clamp((xyz - lo) / scale, 0.0, 1.0 - 1e-7)
    cell = (q * 1024.0).to(torch.int32)  # (..., 3) in [0, 1023]

    def spread(v):  # 10 bits -> every third bit
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return spread(cell[..., 0]) | (spread(cell[..., 1]) << 1) | (spread(cell[..., 2]) << 2)


def real_points(xyz: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (...) bool: the points that are no sentinel."""
    return torch.all(xyz.abs() < SENTINEL_MIN, dim=-1)


def tile_bounds(sorted_xyz: torch.Tensor, tile: int, mask=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, N, 3) -> per-tile boxes lo, hi (B, N // tile, 3) over the points
    that ``mask`` (B, N) selects, the real points when None; a tile without
    one gets (+inf, -inf): an infinite lower bound."""
    B, N, _ = sorted_xyz.shape
    t = sorted_xyz.reshape(B, N // tile, tile, 3)
    m = (real_points(sorted_xyz) if mask is None else mask).reshape(B, N // tile, tile, 1)
    lo = torch.where(m, t, float("inf")).amin(dim=2)
    hi = torch.where(m, t, float("-inf")).amax(dim=2)
    return lo, hi


def box_sqdist(alo, ahi, blo, bhi) -> torch.Tensor:
    """Least squared distance between box sets: (B, Mt, 3) x (B, Nt, 3) -> (B, Mt, Nt)."""
    gap = torch.clamp(
        torch.maximum(alo[:, :, None, :] - bhi[:, None, :, :], blo[:, None, :, :] - ahi[:, :, None, :]),
        min=0.0,
    )
    g2 = gap * gap
    return (g2[..., 0] + g2[..., 1]) + g2[..., 2]


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    if rows == x.shape[1]:
        return x
    pad = x.new_full((x.shape[0], rows - x.shape[1], 3), PAD_COORD)
    return torch.cat([x, pad], dim=1)


class Prepared(NamedTuple):
    """The gated kernels' operands (``_prepare``'s outputs).

    q_sorted (B, M_pad, 3) and r_sorted (B, N_pad, 3) Morton-sorted, padded,
    contiguous f32; q_order (B, M), r_order (B, N) sorted position -> original
    index (int64; r_order None when the refs keep their order); order (B, Mt,
    Nt) int32 ref tiles of each query tile in visit order; lb_sorted (B, Mt,
    Nt) f32 their lower bounds."""

    q_sorted: torch.Tensor
    r_sorted: torch.Tensor
    q_order: torch.Tensor
    r_order: torch.Tensor
    order: torch.Tensor
    lb_sorted: torch.Tensor
    tile_m: int
    tile_n: int


def prepare(queries: torch.Tensor, refs: torch.Tensor, tile_m: int, tile_n: int, sort_refs: bool = True) -> Prepared:
    """Morton-sort queries and refs (box from the queries; the refs only with
    ``sort_refs``), pad to tiles, and rank each query tile's ref tiles by
    their lower bound."""
    B, M, _ = queries.shape
    N = refs.shape[1]
    q = queries.float()
    r = refs.float()
    # the quantization box comes from the queries (the chunk): refs far
    # outside clamp to boundary cells, their tiles get far boxes
    lo = q.amin(dim=1, keepdim=True)
    hi = q.amax(dim=1, keepdim=True)
    q_order = torch.argsort(morton_code(q, lo, hi), dim=1, stable=True)
    q_sorted = torch.gather(q, 1, q_order[..., None].expand(-1, -1, 3))
    r_order, r_sorted = None, r
    if sort_refs:
        r_order = torch.argsort(morton_code(r, lo, hi), dim=1, stable=True)
        r_sorted = torch.gather(r, 1, r_order[..., None].expand(-1, -1, 3))
    q_sorted = _pad_rows(q_sorted, -(-M // tile_m) * tile_m).contiguous()
    r_sorted = _pad_rows(r_sorted, -(-N // tile_n) * tile_n).contiguous()
    lb = box_sqdist(*tile_bounds(q_sorted, tile_m), *tile_bounds(r_sorted, tile_n))
    order = torch.argsort(lb, dim=-1, stable=True)  # nearest tiles first
    lb_sorted = torch.gather(lb, -1, order).contiguous()
    return Prepared(q_sorted, r_sorted, q_order, r_order, order.to(torch.int32).contiguous(), lb_sorted, tile_m, tile_n)


class DevicePrepared(NamedTuple):
    """``prepare_device``'s operands of the gated search kernels.

    q4 (B, M_pad, 4) f32: the Morton-sorted queries padded with PAD_COORD,
    each original query index's int32 bits in the 4th coordinate (-1 for
    padding); r4 (B, N_pad, 4) f32: the sorted refs (with ``sort_refs``
    False, the refs in their order) padded with PAD_COORD, each original ref
    index in the 4th coordinate (padding: the last sorted ref's, which
    ``unmap``'s clamp names); rbox (B, Nt, 6) f32 each ref tile's box over its
    real refs (lo, hi; an empty box is (+inf, -inf)); order and lb_sorted as
    ``Prepared``'s."""

    q4: torch.Tensor
    r4: torch.Tensor
    rbox: torch.Tensor
    order: torch.Tensor
    lb_sorted: torch.Tensor
    m: int
    n: int
    sort_refs: bool
    tile_m: int
    tile_n: int

    def plain_view(self) -> Prepared:
        """The same operands in ``prepare``'s layout (to hold them against it)."""

        def index(x, n):  # the original indices the 4th coordinate carries
            return x[:, :n, 3].contiguous().view(torch.int32).long()

        return Prepared(
            self.q4[..., :3].contiguous(), self.r4[..., :3].contiguous(), index(self.q4, self.m),
            index(self.r4, self.n) if self.sort_refs else None, self.order, self.lb_sorted, self.tile_m, self.tile_n,
        )


# calls of prepare_device (each launches the kernels of csrc/morton.cu:
# the box, the codes, SORT_PASSES passes of the radix sort, the gather and
# the visit order)
launches = 0
SORT_TILE = 4096  # keys a block of the radix sort (csrc/morton.cu kSortTile)
SORT_PASSES = 4


@torch.no_grad()
def prepare_device(queries: torch.Tensor, refs: torch.Tensor, tile_m: int, tile_n: int,
                   sort_refs: bool = True) -> DevicePrepared:
    """``prepare`` on the card, in csrc/morton.cu's kernels (the op
    ``mvpnet::morton_prep``, ``ops/_library.py``): the query box, both
    sides' Morton codes and one stable radix sort of each row's keys (the
    queries' first, then the refs'), then the gather with the tile boxes and
    each query tile's bounds in visit order: eight launches. CUDA tensors
    only (``prepare`` is the plain version; ``prepare_device_plain`` gives
    its output in this layout)."""
    _cuda.check_xyz(queries, "queries")
    _cuda.check_xyz(refs, "refs", queries.shape[0])
    _cuda.same_device(queries, refs)
    if not queries.is_cuda:
        raise ValueError("prepare_device launches kernels: it needs CUDA tensors (prepare is the plain version)")
    q4, r4, *rest = torch.ops.mvpnet.morton_prep(queries, refs, tile_m, tile_n, sort_refs)
    return DevicePrepared(q4.view(torch.float32), r4.view(torch.float32), *rest, queries.shape[1], refs.shape[1],
                          sort_refs, tile_m, tile_n)


def launch_prep(queries: torch.Tensor, refs: torch.Tensor, tile_m: int, tile_n: int, sort_refs: bool = True):
    """The CUDA implementation of ``mvpnet::morton_prep``: (q4, r4, rbox,
    order, lb_sorted) of ``DevicePrepared``, q4 and r4 as their int32 words
    (each point's 4th word is an index, and the -1 of a pad row is a NaN's
    bits as a float: the words compare exactly)."""
    global launches
    B, M, _ = queries.shape
    N = refs.shape[1]
    q = queries.float().contiguous()
    r = refs.float().contiguous()
    M_pad, N_pad = -(-M // tile_m) * tile_m, -(-N // tile_n) * tile_n
    Mt, Nt = M_pad // tile_m, N_pad // tile_n
    f32 = dict(dtype=torch.float32, device=q.device)
    box = torch.empty((B, 6), **f32)
    S = M + N if sort_refs else M
    i32 = dict(dtype=torch.int32, device=q.device)
    keys, perm = torch.empty((2, B, S), **i32), torch.empty((2, B, S), **i32)
    hist = torch.empty((SORT_PASSES, B, -(-S // SORT_TILE), 256), **i32)
    stream = _cuda.stream(q)
    _cuda.launch(_cuda.function("morton", "morton_sort"), q.data_ptr(), r.data_ptr(), B, M, N, int(sort_refs),
                 box.data_ptr(), keys.data_ptr(), perm.data_ptr(), hist.data_ptr(), stream)
    q4, r4 = torch.empty((B, M_pad, 4), **f32), torch.empty((B, N_pad, 4), **f32)
    qbox, rbox = torch.empty((B, Mt, 6), **f32), torch.empty((B, Nt, 6), **f32)
    order = torch.empty((B, Mt, Nt), dtype=torch.int32, device=q.device)
    lb_sorted = torch.empty((B, Mt, Nt), **f32)
    _cuda.launch(_cuda.function("morton", "morton_tiles"), q.data_ptr(), r.data_ptr(), perm[0].data_ptr(), B, M, N,
                 M_pad, N_pad, tile_m, tile_n, int(sort_refs), q4.data_ptr(), r4.data_ptr(), qbox.data_ptr(),
                 rbox.data_ptr(), order.data_ptr(), lb_sorted.data_ptr(), stream)
    launches += 1
    return q4.view(torch.int32), r4.view(torch.int32), rbox, order, lb_sorted


def prepare_device_plain(queries: torch.Tensor, refs: torch.Tensor, tile_m: int, tile_n: int, sort_refs: bool = True):
    """The plain chain (``prepare``) in ``prepare_device``'s layout: (q4, r4,
    rbox, order, lb_sorted), each point's original index in its 4th word (-1
    for a pad query row, the last sorted ref's for a pad ref), q4 and r4 as
    int32 words. The CPU implementation of ``mvpnet::morton_prep``."""
    p = prepare(queries, refs, tile_m, tile_n, sort_refs)
    B, M = p.q_order.shape
    N = refs.shape[1]
    q_index = torch.full((B, p.q_sorted.shape[1]), -1, dtype=torch.int32, device=queries.device)
    q_index[:, :M] = p.q_order
    r_index = p.r_order if sort_refs else torch.arange(N, device=refs.device).expand(B, N)
    r_index = r_index.to(torch.int32)
    r_index = torch.cat([r_index, r_index[:, -1:].expand(B, p.r_sorted.shape[1] - N)], dim=1)

    def with_index(xyz, index):
        return torch.cat([xyz.view(torch.int32), index[..., None]], dim=-1)

    rlo, rhi = tile_bounds(p.r_sorted, tile_n)
    return (with_index(p.q_sorted, q_index), with_index(p.r_sorted, r_index), torch.cat([rlo, rhi], dim=-1),
            p.order, p.lb_sorted)


class PreparedRefs(NamedTuple):
    """A ref cloud prepared for the demand-gated fusion kNN (the counterpart
    of ``knn_bucketed.py::PreparedRefs``, ``prepare_refs`` :887).

    r4 (B, N_pad, 4) f32: the Morton-sorted refs padded with PAD_COORD, the
    original index's int32 bits in the 4th coordinate (JAX's r_order; -1 for
    padding); boxes (B, Nt, 12) f32 each tile's box over its real refs (JAX's
    rlo, rhi) and over its sentinel refs (|c| >= SENTINEL_MIN; the padding is
    no ref): real lo, real hi, sentinel lo, sentinel hi, an empty box as
    (+inf, -inf); refs the raw (B, N, 3) refs, which the backward uses."""

    r4: torch.Tensor
    boxes: torch.Tensor
    refs: torch.Tensor
    n: int
    tile_n: int


def demand_tiles(M: int, N: int) -> tuple[int, int, bool]:
    """(tile_m, tile_n, sub_gate) of the demand-gated kernel for M queries
    over N refs, as ``_knn_forward_demand``: 128 / 4096 and the sub-gate
    from BIG_N refs up, 64 / 2048 below, query tiles no taller than the
    queries (at least SUB rows, rounded up to a multiple of SUB: a warp of
    the kernel holds SUB rows)."""
    big = N >= BIG_N
    rows = -(-max(SUB, M) // SUB) * SUB
    return min(DEMAND_TILE_M if big else DEMAND_TILE_M_SMALL, rows), (DEMAND_TILE_N_BIG if big else TILE_N), big


@torch.no_grad()
def prepare_refs(refs: torch.Tensor, tile_n: int, lo=None, hi=None) -> PreparedRefs:
    """Morton-sort a ref cloud, pad it to tiles and bound its tiles.

    The quantization box is (lo, hi), (B, 1, 3) each, when given (the
    per-call search boxes by its queries, as ``_prepare`` does), else the
    refs' real coordinates (``prepare_refs``: the result does not depend on
    any query). The box decides only how local the tiles are; the bounds
    are taken over the refs themselves."""
    B, N, _ = refs.shape
    r = refs.float()
    if lo is None:
        real = real_points(r)[..., None]
        lo = torch.where(real, r, float("inf")).amin(dim=1, keepdim=True)
        hi = torch.where(real, r, float("-inf")).amax(dim=1, keepdim=True)
    r_order = torch.argsort(morton_code(r, lo, hi), dim=1, stable=True)
    r_sorted = _pad_rows(torch.gather(r, 1, r_order[..., None].expand(-1, -1, 3)), -(-N // tile_n) * tile_n)
    n_pad = r_sorted.shape[1]
    real = real_points(r_sorted)
    rlo, rhi = tile_bounds(r_sorted, tile_n, real)
    # the sentinel box: refs that are no real point and no padding
    sentinel = ~real
    sentinel[:, N:] = False
    slo, shi = tile_bounds(r_sorted, tile_n, sentinel)
    index = torch.full((B, n_pad, 1), -1, dtype=torch.int32, device=r.device)
    index[:, :N, 0] = r_order
    r4 = torch.cat([r_sorted, index.view(torch.float32)], dim=-1).contiguous()
    boxes = torch.cat([rlo, rhi, slo, shi], dim=-1).contiguous()
    return PreparedRefs(r4, boxes, refs, N, tile_n)


@torch.no_grad()
def prepare_queries(queries: torch.Tensor, p: PreparedRefs, tile_m: int):
    """The query side of the demand-gated search (``_knn_prepared_impl``
    :935-969): queries Morton-sorted by their own box and padded to tiles,
    each query tile's box over its real rows (by index: no coordinate of a
    query is read as a sentinel), and its bound to each ref tile, the least
    of the bounds to the tile's real and sentinel boxes, so that it holds
    for every ref in the tile. Returns q_sorted (B, M_pad, 3), q_order
    (B, M), order (B, Mt, Nt) int32 ref tiles in ascending bound order
    (stable), lb_sorted (B, Mt, Nt) f32."""
    B, M, _ = queries.shape
    q = queries.float()
    q_order = torch.argsort(morton_code(q, q.amin(dim=1, keepdim=True), q.amax(dim=1, keepdim=True)), dim=1, stable=True)
    q_sorted = _pad_rows(torch.gather(q, 1, q_order[..., None].expand(-1, -1, 3)), -(-M // tile_m) * tile_m).contiguous()
    m_pad = q_sorted.shape[1]
    qlo, qhi = tile_bounds(q_sorted, tile_m, (torch.arange(m_pad, device=q.device) < M).expand(B, m_pad))
    b = p.boxes
    lb = torch.minimum(box_sqdist(qlo, qhi, b[..., 0:3], b[..., 3:6]), box_sqdist(qlo, qhi, b[..., 6:9], b[..., 9:12]))
    order = torch.argsort(lb, dim=-1, stable=True)
    return q_sorted, q_order, order.to(torch.int32).contiguous(), torch.gather(lb, -1, order).contiguous()


def inverse_perm(order: torch.Tensor) -> torch.Tensor:
    """Invert a (B, M) permutation by one scatter."""
    B, M = order.shape
    iota = torch.arange(M, device=order.device).expand(B, M)
    return torch.empty_like(iota).scatter_(1, order.long(), iota)


def unmap(d_s, i_s, q_order, r_order, M: int, N: int):
    """Sorted-space kernel outputs (B, M_pad, k) -> original query order and
    original ref indices (int32; ``r_order`` None: the refs kept their order)."""
    B, _, k = d_s.shape
    d_s, i_s = d_s[:, :M], i_s[:, :M]
    # padding columns win only when a row has fewer than k real refs; the
    # clamp keeps the gather in range
    i_orig = i_s.long().clamp(0, N - 1)
    if r_order is not None:
        i_orig = torch.gather(r_order, 1, i_orig.reshape(B, M * k)).reshape(B, M, k)
    inv = inverse_perm(q_order)[..., None].expand(-1, -1, k)
    return torch.gather(d_s, 1, inv), torch.gather(i_orig, 1, inv).to(torch.int32)


def visit_columns(p: Prepared) -> torch.Tensor:
    """(B, Mt, N_pad) int64: each query tile's sorted ref columns in visit
    order (its tiles in ``order``, each tile's columns ascending)."""
    cols = torch.arange(p.tile_n, device=p.order.device)
    B, Mt, Nt = p.order.shape
    return (p.order.long()[..., None] * p.tile_n + cols).reshape(B, Mt, Nt * p.tile_n)


def gated_plain(queries, refs, k: int, tile_m: int, tile_n: int, rows=None, block_elems: int = 1 << 26,
                sort_refs: bool = True):
    """Plain version of the gated kernels: what they return, computed without
    the gate.

    After ``prepare``, each query's squared distances to every sorted ref,
    with the columns permuted into its query tile's visit order, go through a
    stable sort; the first k are the result. That equals the gated search
    exactly, visit-order ties included: a skipped tile cannot beat the k-th
    distance, and an equal one loses the tie. ``rows`` (a 1-D index tensor)
    restricts the output to those original queries (the prepare still sees
    every query, as the kernel does); ``sort_refs``: ``prepare``'s. Returns
    (B, R, k) f32 and int32."""
    from mvpnet_torch.ops.reference import sqdist

    B, M, _ = queries.shape
    N = refs.shape[1]
    p = prepare(queries, refs, tile_m, tile_n, sort_refs)
    rows = torch.arange(M, device=queries.device) if rows is None else rows.to(queries.device).long()
    pos = inverse_perm(p.q_order)[:, rows]  # (B, R) sorted rows of the chosen queries
    visit = visit_columns(p)
    R = pos.shape[1]
    n_pad = p.r_sorted.shape[1]
    d_out = torch.empty((B, R, k), dtype=torch.float32, device=queries.device)
    i_out = torch.empty((B, R, k), dtype=torch.int32, device=queries.device)
    step = max(1, block_elems // (B * n_pad))
    for s in range(0, R, step):
        e = min(R, s + step)
        qs = torch.gather(p.q_sorted, 1, pos[:, s:e, None].expand(-1, -1, 3))
        cols = torch.gather(visit, 1, (pos[:, s:e] // tile_m)[..., None].expand(-1, -1, n_pad))
        d2 = torch.gather(sqdist(qs, p.r_sorted), 2, cols)  # (B, r, N_pad) in visit order
        d_sorted, at = torch.sort(d2, dim=-1, stable=True)
        i_sorted = torch.gather(cols, 2, at[..., :k]).clamp(0, N - 1)
        d_out[:, s:e] = d_sorted[..., :k]
        if p.r_order is not None:
            i_sorted = torch.gather(p.r_order, 1, i_sorted.reshape(B, -1)).reshape(B, e - s, k)
        i_out[:, s:e] = i_sorted.to(torch.int32)
    return d_out, i_out
