"""The CUDA kernels as ``torch.library`` custom ops, in the namespace ``mvpnet``.

Each op sits at the level of a kernel's wrapper function, not of its raw
launch. It takes the wrapper's tensors and ints and has
  * a CUDA implementation, the wrapper's body (``launch`` in its module): the
    layout from the shape and the card, ``_cuda.function``, ``_cuda.launch``
    and the launch counter. It runs on real tensors at every call, of a
    loaded ``torch.export`` artifact too, so ``ops.launch_counts()`` counts
    an artifact's forwards as it counts eager ones;
  * a CPU implementation, the kernel's plain version (the one the tests and
    chip_smoke.py hold it against);
  * a fake implementation: the output shapes and dtypes (int32 indices, f32
    distances), which ``torch.export`` traces with.

What reads only shapes is decided by the public wrapper before the op
(``knn_bucketed.route``'s mode, ``fps.route``'s kernel) and an export freezes
it into the graph; what reads data or addresses runs inside the op. The
fusion searches' ``scanned``, the pair counter that chip_smoke.py passes
(and ``ops.knn`` while a profiler records, ``tracing.pairs_counter``), is
declared mutated: the CUDA implementation adds to it when one is given, the
CPU implementation leaves it.

``mvpnet_torch.ops`` imports this module, so the ops are registered before
a wrapper or a loaded artifact calls them.
"""
from typing import Optional

import torch
from torch import Tensor

from mvpnet_torch.ops import ballquery, fps, knn, knn_bucketed, knn_gated, knn_resident, morton, reference


def _op(name: str, mutates_args=()):
    """Decorator: a CUDA implementation becomes the op ``mvpnet::<name>``."""
    return torch.library.custom_op(f"mvpnet::{name}", mutates_args=mutates_args, device_types="cuda")


def _knn_shapes(queries, refs, k, *args, **kwargs):
    B, M, _ = queries.shape
    return queries.new_empty((B, M, k), dtype=torch.float32), queries.new_empty((B, M, k), dtype=torch.int32)


@_op("knn_fusion", mutates_args=("scanned",))
def knn_fusion(queries: Tensor, refs: Tensor, k: int, route: str, scanned: Optional[Tensor]) -> tuple[Tensor, Tensor]:
    """Row 1, csrc/knn_fusion.cu, in the mode ``route`` ("demand", "brute";
    an op's argument may not be named ``mode``, a keyword that
    auto-functionalization takes)."""
    return knn_bucketed.launch(queries, refs, k, route, scanned)


@knn_fusion.register_kernel("cpu")
def _(queries, refs, k, route, scanned):
    return reference.knn(queries, refs, k)


@_op("knn_prepared", mutates_args=("scanned",))
def knn_prepared(queries: Tensor, r4: Tensor, boxes: Tensor, refs: Tensor, n: int, tile_n: int, k: int,
                 scanned: Optional[Tensor]) -> tuple[Tensor, Tensor]:
    """Row 1's demand mode against a prepared cloud (``morton.PreparedRefs``'s fields)."""
    return knn_bucketed.launch_prepared(queries, morton.PreparedRefs(r4, boxes, refs, n, tile_n), k, scanned)


@knn_prepared.register_kernel("cpu")
def _(queries, r4, boxes, refs, n, tile_n, k, scanned):
    return reference.knn(queries, refs, k)


@knn_prepared.register_fake
def _(queries, r4, boxes, refs, n, tile_n, k, scanned):
    return _knn_shapes(queries, refs, k)


@_op("fps")
def fps_block(points: Tensor, npoint: int, valid_mask: Optional[Tensor]) -> Tensor:
    """Row 2, csrc/fps.cu ``fps``: the row in one block."""
    return fps.launch(points, npoint, valid_mask)


@_op("fps_perrow")
def fps_perrow(points: Tensor, npoint: int, valid_mask: Optional[Tensor]) -> Tensor:
    """Row 5, csrc/fps.cu ``fps_perrow``: the row on a thread-block cluster."""
    return fps.launch_perrow(points, npoint, valid_mask)


for _fps_op in (fps_block, fps_perrow):
    _fps_op.register_kernel("cpu")(reference.farthest_point_sample)

    @_fps_op.register_fake
    def _(points, npoint, valid_mask):
        return points.new_empty((points.shape[0], npoint), dtype=torch.int32)


@_op("ball_query")
def ball_query(centers: Tensor, points: Tensor, radius: float, nsample: int,
               valid_mask: Optional[Tensor]) -> tuple[Tensor, Tensor]:
    """Row 3, csrc/ballquery.cu."""
    return ballquery.launch(centers, points, radius, nsample, valid_mask)


ball_query.register_kernel("cpu")(reference.ball_query)


@ball_query.register_fake
def _(centers, points, radius, nsample, valid_mask):
    B, M, _ = centers.shape
    return centers.new_empty((B, M, nsample), dtype=torch.int32), centers.new_empty((B, M), dtype=torch.int32)


@_op("knn")
def knn_brute(queries: Tensor, refs: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """Row 4, csrc/knn.cu: the brute three-NN."""
    return knn.launch(queries, refs, k)


knn_brute.register_kernel("cpu")(reference.knn)


@_op("knn_gated", mutates_args=("scanned",))
def knn_gated_op(queries: Tensor, refs: Tensor, k: int, sort_refs: bool,
                 scanned: Optional[Tensor]) -> tuple[Tensor, Tensor]:
    """Row 6, csrc/knn_gated.cu, after the Morton prep (``mvpnet::morton_prep``)."""
    return knn_gated.launch(queries, refs, k, sort_refs, scanned)


@knn_gated_op.register_kernel("cpu")
def _(queries, refs, k, sort_refs, scanned):
    return knn_gated.plain(queries, refs, k, sort_refs=sort_refs)


@_op("knn_resident", mutates_args=("scanned",))
def knn_resident_op(queries: Tensor, refs: Tensor, k: int, sort_refs: bool,
                    scanned: Optional[Tensor]) -> tuple[Tensor, Tensor]:
    """Row 7, csrc/knn_resident.cu, after the Morton prep."""
    return knn_resident.launch(queries, refs, k, sort_refs, scanned)


@knn_resident_op.register_kernel("cpu")
def _(queries, refs, k, sort_refs, scanned):
    return knn_resident.plain(queries, refs, k, sort_refs=sort_refs)


for _knn_op in (knn_fusion, knn_brute, knn_gated_op, knn_resident_op):
    _knn_op.register_fake(_knn_shapes)


@_op("morton_prep")
def morton_prep(queries: Tensor, refs: Tensor, tile_m: int, tile_n: int,
                sort_refs: bool) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """The prep of rows 6 and 7, csrc/morton.cu: ``morton.DevicePrepared``'s
    tensors, q4 and r4 as int32 words."""
    return morton.launch_prep(queries, refs, tile_m, tile_n, sort_refs)


morton_prep.register_kernel("cpu")(morton.prepare_device_plain)


@morton_prep.register_fake
def _(queries, refs, tile_m, tile_n, sort_refs):
    B, M, _ = queries.shape
    N = refs.shape[1]
    Mt, Nt = -(-M // tile_m), -(-N // tile_n)
    f32, i32 = dict(dtype=torch.float32), dict(dtype=torch.int32)
    return (queries.new_empty((B, Mt * tile_m, 4), **i32), queries.new_empty((B, Nt * tile_n, 4), **i32),
            queries.new_empty((B, Nt, 6), **f32), queries.new_empty((B, Mt, Nt), **i32),
            queries.new_empty((B, Mt, Nt), **f32))


# every op, by name (its CUDA kernel's entry in ops.KERNELS, and the prepared
# search of row 1)
OPS = {
    "knn_fusion": knn_fusion, "knn_prepared": knn_prepared, "fps": fps_block, "fps_perrow": fps_perrow,
    "ball_query": ball_query, "knn": knn_brute, "knn_gated": knn_gated_op, "knn_resident": knn_resident_op,
    "morton_prep": morton_prep,
}
