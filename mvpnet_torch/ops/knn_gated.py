"""Gated fusion-scale exact kNN: wrapper of the CUDA kernel ``csrc/knn_gated.cu``.

Counterpart of ``mvpnet_tpu/ops/pallas/knn_bucketed.py::_knn_forward``
(``_gated_kernel``), which the JAX package runs for a fusion-size search when
``_USE_DEMAND`` is False; here ``ops.set_fusion_variant("gated")``. The
queries and refs are Morton-sorted and ranked by tile on the card
(``morton.prepare_device``, ``csrc/morton.cu``), the kernel walks each query
tile's ref tiles in ascending lower-bound order, skips those that cannot
improve a warp's rows, and writes the original query order and ref indices
itself. Ties between equal distances follow that visit order.

The kernel's schedule (lanes a query row, rows a block) comes from
``layout``, by the shape and the card's SM count; ``knn_at`` runs any
layout, and ``split_emulation`` is the schedule and its gates in plain
PyTorch, for the tests.

``knn`` calls the op ``mvpnet::knn_gated`` (``ops/_library.py``): a CUDA
tensor launches the kernels (``launch``); a CPU tensor takes the plain
version (``morton.gated_plain``). ``launches`` counts search-kernel launches
(the prep's are ``morton.launches``).
"""
from __future__ import annotations

import torch

from mvpnet_torch.ops import _cuda, morton
from mvpnet_torch.ops.knn import _sms, check_args

# csrc/knn_gated.cu, csrc/knn_resident.cu: threads a block at most
MAX_THREADS = 512
MAX_LANES = 32
# layout's lanes a query row: 8 on tiles of up to 2048 refs, 16 on the
# 8192-ref tiles from BIG_N refs up (the fastest, or within 4% of it, at the
# train and scene shapes on an H100: profile_levels.py's layout sweep,
# PERF.md); more while the grid has fewer threads than the card holds
LANES, BIG_TILE_LANES = 8, 16
SM_THREADS = 2048
launches = 0


def tiles(M: int, N: int) -> tuple[int, int, bool]:
    """(tile_m, tile_n, big) of ``_knn_forward``'s policy: 256-row query
    tiles, 2048-ref tiles below 2^18 refs, 8192-ref tiles at and above (where
    the TPU kernel also gates 8-row subgroups; the kernel here gates each
    warp's rows at every size)."""
    big = N >= morton.BIG_N
    tile_m = min(morton.TILE_M, max(morton.SUB, M))
    return tile_m, (morton.TILE_N_BIG if big else morton.TILE_N), big


def layout(batch: int, queries: int, tile_m: int, tile_n: int, sms: int) -> tuple[int, int]:
    """(lanes, rows) of the gated search of ``batch`` rows of ``queries``
    queries in tiles of ``tile_m`` rows and ``tile_n`` refs on a card of
    ``sms`` SMs: lanes a query row, LANES (BIG_TILE_LANES on tiles longer
    than morton.TILE_N), doubled up to MAX_LANES while the grid's threads do
    not fill the card (SM_THREADS an SM); rows a block, the tile's or as many
    as MAX_THREADS threads hold."""
    lanes = BIG_TILE_LANES if tile_n > morton.TILE_N else LANES
    while lanes < MAX_LANES and batch * queries * lanes < sms * SM_THREADS:
        lanes *= 2
    return lanes, min(tile_m, MAX_THREADS // lanes)


def plain(queries: torch.Tensor, refs: torch.Tensor, k: int, rows=None, sort_refs: bool = True):
    """The kernel's plain version (``morton.gated_plain`` at this policy's tiles)."""
    tile_m, tile_n, _ = tiles(queries.shape[1], refs.shape[1])
    return morton.gated_plain(queries, refs, k, tile_m, tile_n, rows=rows, sort_refs=sort_refs)


def knn(queries: torch.Tensor, refs: torch.Tensor, k: int, scanned: torch.Tensor | None = None,
        sort_refs: bool = True):
    """(B, M, 3), (B, N, 3) -> (B, M, k) f32 squared distances, ascending,
    and (B, M, k) int32 indices; ties follow the visit order. ``scanned``, an
    int64 CUDA tensor of one element, gets the (query, ref) pairs the kernel's
    gates let through added to it. ``sort_refs`` False keeps the refs in their
    order (``ops.knn``'s ``refs_coherent``)."""
    check_args(queries, refs, k)
    return torch.ops.mvpnet.knn_gated(queries, refs, k, sort_refs, scanned)


def launch(queries, refs, k: int, sort_refs: bool = True, scanned=None):
    """The CUDA implementation of ``mvpnet::knn_gated``: the prep and the
    kernel at ``layout``'s layout for this shape and card."""
    tile_m, tile_n, _ = tiles(queries.shape[1], refs.shape[1])
    B, M, _ = queries.shape
    return knn_at(queries, refs, k, *layout(B, M, tile_m, tile_n, _sms(queries.device)), scanned, sort_refs)


def knn_at(queries, refs, k: int, lanes: int, rows: int, scanned=None, sort_refs: bool = True):
    """The prep and the kernel at a given layout (``knn`` takes ``layout``'s),
    counted in ``launches``. CUDA tensors only."""
    global launches
    tile_m, tile_n, _ = tiles(queries.shape[1], refs.shape[1])
    out = run("knn_gated", queries, refs, k, tile_m, tile_n, lanes, rows, scanned, sort_refs)
    launches += 1
    return out


def run(kernel: str, queries, refs, k: int, tile_m: int, tile_n: int, lanes: int, rows: int, scanned,
        sort_refs: bool):
    """Prepare on the card (``morton.prepare_device``) and launch ``kernel``
    of ``csrc/<kernel>.cu`` on its operands; it writes the original order.
    Shared with ``knn_resident``."""
    check_args(queries, refs, k)
    if not queries.is_cuda:
        raise ValueError(f"{kernel} launches the kernel: it needs CUDA tensors")
    B, M, _ = queries.shape
    p = morton.prepare_device(queries, refs, tile_m, tile_n, sort_refs)
    d = torch.empty((B, M, k), dtype=torch.float32, device=queries.device)
    i = torch.empty((B, M, k), dtype=torch.int32, device=queries.device)
    _cuda.launch(
        _cuda.function(kernel, kernel),
        p.q4.data_ptr(), p.r4.data_ptr(), p.order.data_ptr(), p.lb_sorted.data_ptr(), p.rbox.data_ptr(),
        B, M, p.q4.shape[1], p.r4.shape[1], tile_m, tile_n, k, lanes, rows, d.data_ptr(), i.data_ptr(),
        None if scanned is None else _cuda.counter_ptr(scanned, queries), _cuda.stream(queries),
    )
    return d, i


INT_MAX = 2**31 - 1


def _first_k(d, pos, k: int):
    """The first k of lists (..., n) in (distance, position) order."""
    by_pos = torch.sort(pos, dim=-1, stable=True).indices
    d, pos = d.gather(-1, by_pos), pos.gather(-1, by_pos)
    by_d = torch.sort(d, dim=-1, stable=True).indices[..., :k]
    return d.gather(-1, by_d), pos.gather(-1, by_d)


def split_emulation(queries, refs, k: int, tile_m: int, tile_n: int, lanes: int, rows: int,
                    first_always: bool = True, sort_refs: bool = True):
    """The gated kernels' schedule and gates in plain PyTorch (``gated_search``
    in ``csrc/common.cuh``). After ``morton.prepare``, a block holds ``rows``
    rows of a query tile, a row ``lanes`` lanes, a warp 32 // lanes rows. Per
    visit slot t: the block's tile is open iff lb < the block's worst (max
    over its real rows of the row's k-th distance) or t == 0 with
    ``first_always``, and the first closed tile ends its loop; a warp scans an
    open tile iff t == 0 or its box's bound to the tile's box is below its
    worst; lane j takes columns j, j + lanes, ... and inserts a distance
    below both its own k-th and the row's (its lanes merged at the last tile
    end) after every entry it does not exceed; after a scanned tile the
    row's lanes merge, the first k of their union in (distance, visit
    position) order. Returns (B, M, k) f32, int32 in the original order and
    the (real row, ref) pairs scanned. tile_n a multiple of lanes."""
    from mvpnet_torch.ops.reference import sqdist

    if tile_n % lanes:
        raise ValueError(f"the emulation takes tiles of a multiple of {lanes} refs, got {tile_n}")
    B, M, _ = queries.shape
    N = refs.shape[1]
    p = morton.prepare(queries, refs, tile_m, tile_n, sort_refs)
    M_pad, N_pad = p.q_sorted.shape[1], p.r_sorted.shape[1]
    Mt, Nt = M_pad // tile_m, N_pad // tile_n
    parts = -(-tile_m // rows)
    R = parts * rows  # rows of a query tile's blocks, the last block's tail included
    trow = torch.arange(R)
    srow = torch.arange(Mt)[:, None] * tile_m + trow  # (Mt, R) sorted rows
    real = ((trow < tile_m) & (srow < M)).expand(B, Mt, R)
    qs = p.q_sorted[:, srow.clamp(max=M_pad - 1).reshape(-1)].reshape(B, Mt, R, 3)
    warp_rows = 32 // lanes
    per_block = -(-rows // warp_rows)  # warps a block
    G = parts * per_block
    group = (trow // rows) * per_block + (trow % rows) // warp_rows  # (R,) warp of each row
    block = trow // rows
    inf = torch.tensor(float("inf"))
    one_hot = torch.nn.functional.one_hot(group, G).bool()  # (R, G)
    rq = real[..., None] & one_hot  # (B, Mt, R, G)
    glo = torch.where(rq[..., None], qs[:, :, :, None, :], inf).amin(2)  # (B, Mt, G, 3)
    ghi = torch.where(rq[..., None], qs[:, :, :, None, :], -inf).amax(2)
    group_real = rq.any(2)  # (B, Mt, G)
    rlo, rhi = morton.tile_bounds(p.r_sorted, tile_n)  # (B, Nt, 3)
    bd = torch.full((B, Mt, R, lanes, k), float("inf"))
    bp = torch.full((B, Mt, R, lanes, k), INT_MAX, dtype=torch.long)
    kth = torch.full((B, Mt, R), float("inf"))
    worst = torch.full((B, Mt, parts), float("inf"))
    running = torch.ones((B, Mt, parts), dtype=torch.bool)
    slot = torch.arange(k)
    scanned = 0
    for t in range(Nt):
        lbt = p.lb_sorted[..., t][..., None]  # (B, Mt, 1)
        running &= (t == 0 and first_always) | (lbt < worst)
        if not running.any():
            break
        tile_id = p.order[..., t].long()  # (B, Mt)
        tlo = torch.gather(rlo, 1, tile_id[..., None].expand(-1, -1, 3))[:, :, None, :]
        thi = torch.gather(rhi, 1, tile_id[..., None].expand(-1, -1, 3))[:, :, None, :]
        lb_w = morton.box_sqdist(glo.reshape(-1, G, 3), ghi.reshape(-1, G, 3), tlo.reshape(-1, 1, 3),
                                 thi.reshape(-1, 1, 3)).reshape(B, Mt, G)
        kth_w = torch.where(rq, kth[..., None], -inf).amax(2)  # (B, Mt, G)
        scan_w = group_real & ((t == 0) | (lb_w < kth_w))
        scan_w &= running.repeat_interleave(per_block, dim=2)
        scan = scan_w[:, :, group]  # (B, Mt, R)
        scanned += int((scan & real).sum()) * tile_n
        cols = tile_id[..., None] * tile_n + torch.arange(tile_n)  # (B, Mt, tile_n)
        rt = torch.gather(p.r_sorted, 1, cols.reshape(B, -1, 1).expand(-1, -1, 3)).reshape(B, Mt, tile_n, 3)
        d_all = sqdist(qs, rt)  # (B, Mt, R, tile_n)
        for step in range(tile_n // lanes):
            c = step * lanes + torch.arange(lanes)  # each lane's column
            d = d_all[..., c]  # (B, Mt, R, lanes)
            take = scan[..., None] & (d < torch.minimum(bd[..., -1], kth[..., None]))
            at = (bd <= d[..., None]).sum(-1, keepdim=True)  # after every entry <= d
            shifted_d = torch.cat([bd[..., :1], bd[..., :-1]], -1)
            shifted_p = torch.cat([bp[..., :1], bp[..., :-1]], -1)
            pos = (t * tile_n + c).expand(B, Mt, R, lanes)[..., None]
            new_d = torch.where(slot < at, bd, torch.where(slot == at, d[..., None], shifted_d))
            new_p = torch.where(slot < at, bp, torch.where(slot == at, pos, shifted_p))
            bd = torch.where(take[..., None], new_d, bd)
            bp = torch.where(take[..., None], new_p, bp)
        md, _ = _first_k(bd.reshape(B, Mt, R, lanes * k), bp.reshape(B, Mt, R, lanes * k), k)
        kth = torch.where(scan, md[..., k - 1], kth)
        row_worst = torch.where(real, kth, -inf)
        block_worst = torch.stack([row_worst[..., block == j].amax(-1) for j in range(parts)], -1)
        worst = torch.where(running, block_worst, worst)
    md, mp = _first_k(bd.reshape(B, Mt, R, lanes * k), bp.reshape(B, Mt, R, lanes * k), k)
    slot_of = torch.where(mp == INT_MAX, 0, mp // tile_n)
    col = torch.gather(p.order.long(), 2, slot_of.reshape(B, Mt, -1)).reshape(mp.shape) * tile_n + mp % tile_n
    col = torch.where(mp == INT_MAX, 0, col).clamp(max=N - 1)
    index = col if p.r_order is None else torch.gather(p.r_order, 1, col.reshape(B, -1)).reshape(col.shape)
    keep = real[0].reshape(-1)  # the real rows, in sorted order
    d_out = torch.empty((B, M, k))
    i_out = torch.empty((B, M, k), dtype=torch.int32)
    rows_sorted = srow.reshape(-1)[keep]
    d_out.scatter_(1, p.q_order[:, rows_sorted, None].expand(-1, -1, k), md.reshape(B, -1, k)[:, keep])
    i_out.scatter_(1, p.q_order[:, rows_sorted, None].expand(-1, -1, k),
                   index.reshape(B, -1, k)[:, keep].to(torch.int32))
    return d_out, i_out, scanned
