"""Point-cloud ops: public API with implementation dispatch.

Counterpart of ``mvpnet_tpu/ops/__init__.py``. Every op has two versions
behind one signature:
  * the CUDA kernels (``csrc/*.cu``, wrapped by ``knn``, ``knn_bucketed``,
    ``fps`` and ``ballquery``), each wrapper a ``torch.library`` custom op
    ``torch.ops.mvpnet.*`` (``_library``) whose CPU implementation is its
    plain version, so that ``torch.export`` keeps each kernel as one node;
  * the plain PyTorch versions (``reference``).

``set_impl`` chooses, and a call's ``impl=`` overrides it for that call
alone (``get_impl`` reads it):
  * ``"auto"`` (default): a CUDA tensor launches the kernel, a CPU tensor
    takes the plain version. On the card every FPS, ball query, kNN and
    three-NN call goes through a kernel, at every size.
  * ``"cuda"``: the kernel; a CPU tensor raises.
  * ``"reference"``: the plain version on any device — an explicit opt-in,
    used to hold the kernels against it (chip_smoke.py). Nothing falls back
    to it on its own.

``farthest_point_sample`` launches ``fps`` for rows that fit a block's
shared memory and ``fps_perrow`` for longer ones (``fps.route``).

``knn`` routes ref clouds of >= 2^15 points with >= 256 queries (the fusion
kNN) to one of three kernels and every other search to the brute kernel, as
``mvpnet_tpu/ops/pallas/knn_bucketed.py:86-96`` does. ``set_fusion_variant``
picks the fusion kernel, the counterpart of that file's ``_USE_DEMAND`` and
``use_vmem``:
  * ``"demand"`` (default, as in JAX): ``knn_bucketed`` (``csrc/knn_fusion.cu``);
  * ``"gated"`` (``_USE_DEMAND = False``): ``knn_gated`` (``csrc/knn_gated.cu``);
  * ``"resident"`` (``use_vmem=True``): ``knn_resident``
    (``csrc/knn_resident.cu``), at most 2^17 refs.
The last two prepare their operands on the card (``morton.prepare_device``,
``csrc/morton.cu``, counted as ``"morton_prep"``) and break exact ties by
their visit order, so ``knn``'s ``refs_coherent`` (keep the refs in their
order) can change which of two equal refs they return, as in JAX.

``nearest`` (k=1, whatever the size) always takes the brute kernel.

``knn_prepare`` prepares a large cloud on the card once (Morton sort,
tile boxes) and ``knn_prepared`` then runs the fusion kernel's demand mode
on it, as the JAX package's prepared path does.

``knn`` and ``knn_prepared`` are differentiable in the distances (a
``torch.autograd.Function`` whose backward is ``_knn_bwd``'s plain math,
``mvpnet_tpu/ops/pallas/knn.py:180``); indices carry no gradient, nor do
FPS and ball query, which return only indices.
"""
from __future__ import annotations

import torch

from mvpnet_torch import tracing
from mvpnet_torch.ops import _library  # noqa: F401  (registers the mvpnet:: ops)
from mvpnet_torch.ops import ballquery as _bq
from mvpnet_torch.ops import fps as _fps
from mvpnet_torch.ops import knn as _knn
from mvpnet_torch.ops import knn_bucketed as _knn_bucketed
from mvpnet_torch.ops import knn_gated as _knn_gated
from mvpnet_torch.ops import knn_resident as _knn_resident
from mvpnet_torch.ops import morton as _morton
from mvpnet_torch.ops import reference as _ref
from mvpnet_torch.ops.reference import group_points  # noqa: F401

_IMPLS = ("auto", "reference", "cuda")
_impl = "auto"
FUSION_VARIANTS = ("demand", "gated", "resident")
_fusion_variant = "demand"
# wrapper module of each CUDA kernel, by kernel name. (The function ``knn``
# below shadows the submodule attribute ``ops.knn``; reach the brute
# wrapper module as ``KERNELS["knn"]``.)
KERNELS = {
    "knn_fusion": _knn_bucketed,
    "fps": _fps,
    "fps_perrow": _fps.perrow,
    "ball_query": _bq,
    "knn": _knn,
    "knn_gated": _knn_gated,
    "knn_resident": _knn_resident,
    "morton_prep": _morton,
}


def set_impl(name: str) -> None:
    global _impl
    if name not in _IMPLS:
        raise ValueError(f"unknown ops impl {name!r}; expected one of {_IMPLS}")
    _impl = name


def get_impl() -> str:
    return _impl


def set_fusion_variant(name: str) -> None:
    """Kernel of fusion-size searches: "demand", "gated" or "resident"."""
    global _fusion_variant
    if name not in FUSION_VARIANTS:
        raise ValueError(f"unknown fusion kNN variant {name!r}; expected one of {FUSION_VARIANTS}")
    _fusion_variant = name


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0


def _plain(t, impl: str | None = None) -> bool:
    """True when the plain version runs: explicit "reference" mode (the
    call's ``impl``, else the module's). In "cuda" mode a CPU tensor raises;
    in "auto" the wrapper decides by device."""
    mode = _impl if impl is None else impl
    if mode not in _IMPLS:
        raise ValueError(f"unknown ops impl {mode!r}; expected one of {_IMPLS}")
    if mode == "reference":
        return True
    if mode == "cuda" and not t.is_cuda:
        raise RuntimeError("ops impl 'cuda' needs CUDA tensors, got a CPU tensor")
    return False


def _knn_search(queries, refs, k, impl, refs_coherent=False):
    if _plain(queries, impl):
        return _ref.knn(queries, refs, k)
    if _knn_bucketed.supported(queries.shape[1], refs.shape[1]):
        # the pairs the fusion kernels scan, counted while a profiler records
        scanned = tracing.pairs_counter(queries.device)
        if _fusion_variant == "gated":
            return _knn_gated.knn(queries, refs, k, scanned, sort_refs=not refs_coherent)
        if _fusion_variant == "resident":
            return _knn_resident.knn(queries, refs, k, scanned, sort_refs=not refs_coherent)
        return _knn_bucketed.knn(queries, refs, k, scanned=scanned)
    return _knn.knn(queries, refs, k)


class _KnnFunction(torch.autograd.Function):
    """The dispatched search, differentiable in the distances: backward is
    ``_knn_bwd`` (``mvpnet_tpu/ops/pallas/knn.py:180``) in plain PyTorch,
    dq = sum_k g * 2(q - r[idx]) and dr the index_add_ of -g (duplicates add)."""

    @staticmethod
    def forward(ctx, queries, refs, k, impl, prepared=None, refs_coherent=False):
        if prepared is None or _plain(queries, impl):
            d, idx = _knn_search(queries, refs, k, impl, refs_coherent)
        else:  # refs prepared by knn_prepare: the fusion kernel's demand mode
            d, idx = _knn_bucketed.knn_prepared(queries, prepared, k, tracing.pairs_counter(queries.device))
        ctx.mark_non_differentiable(idx)
        ctx.save_for_backward(queries, refs, idx)
        return d, idx

    @staticmethod
    def backward(ctx, g_d, _g_idx):
        queries, refs, idx = ctx.saved_tensors
        q, r = queries.float(), refs.float()
        B, M, k = idx.shape
        N = r.shape[1]
        flat = idx.reshape(B, M * k).long()
        nbr = torch.gather(r, 1, flat[..., None].expand(-1, -1, 3)).reshape(B, M, k, 3)
        g = g_d.float()[..., None] * (2.0 * (q[:, :, None, :] - nbr))
        dq = g.sum(dim=2).to(queries.dtype) if ctx.needs_input_grad[0] else None
        dr = None
        if ctx.needs_input_grad[1]:
            rows = (flat + torch.arange(B, device=flat.device)[:, None] * N).reshape(-1)
            dr = torch.zeros((B * N, 3), dtype=torch.float32, device=r.device)
            dr.index_add_(0, rows, -g.reshape(B * M * k, 3))
            dr = dr.reshape(B, N, 3).to(refs.dtype)
        return dq, dr, None, None, None, None


def _knn_dispatch(queries, refs, k, impl=None, refs_coherent=False):
    return _KnnFunction.apply(queries, refs, k, impl, None, refs_coherent)


def knn(queries, refs, k: int, ref_mask=None, impl: str | None = None, refs_coherent: bool = False):
    """k nearest neighbors; see reference.knn. Masked refs move to the 1e9
    sentinel (as the Pallas wrappers do) before either version runs.
    ``refs_coherent`` says the refs are spatially coherent in their order
    (scanline pixel clouds): the "gated" and "resident" variants then skip
    the refs' Morton sort, as the JAX package's gated kernel does
    (``_prepare(sort_refs=False)``). Distances do not change, but those
    variants break exact ties by visit order, so the index of one of two
    equal refs can. The default fusion kernel and the plain versions take
    the lower index whatever the order, and ignore it."""
    return _knn_dispatch(queries, _ref.mask_points(refs, ref_mask), k, impl, refs_coherent)


def nearest(queries, refs, impl: str | None = None):
    """Index of each query's nearest ref, (M,) int64, the lower index on
    ties; (M, 3) queries and (N, 3) refs. The brute kernel (row 4,
    ``KERNELS["knn"]``) with k=1 on the card, whatever the size: unlike
    ``knn`` it never routes to the fusion kernels, so it adds no row 1
    launch and nothing to ``knn_fusion.pairs_scanned``. No gradient."""
    q, r = queries[None], refs[None]
    _, idx = _ref.knn(q, r, 1) if _plain(queries, impl) else _knn.knn(q, r, 1)
    return idx[0, :, 0].long()


def farthest_point_sample(points, npoint: int, valid_mask=None, impl: str | None = None):
    """Farthest point sampling; see reference.farthest_point_sample."""
    if _plain(points, impl):
        return _ref.farthest_point_sample(points, npoint, valid_mask)
    return _fps.farthest_point_sample(points, npoint, valid_mask)


def ball_query(centers, points, radius: float, nsample: int, valid_mask=None, impl: str | None = None):
    """Fixed-K radius neighborhood; see reference.ball_query."""
    if _plain(centers, impl):
        return _ref.ball_query(centers, points, radius, nsample, valid_mask)
    return _bq.ball_query(centers, points, radius, nsample, valid_mask)


def three_nn_interpolate(dense_xyz, sparse_xyz, sparse_feat, eps: float = 1e-8, impl: str | None = None):
    """Inverse-distance-weighted 3-NN upsampling; the 3-NN search goes
    through the dispatched kNN (a kernel on the card)."""
    d2, idx = _knn_dispatch(dense_xyz, sparse_xyz, 3, impl)
    return _ref.interpolate(d2, idx, sparse_feat, eps)


class RawRefs:
    """``knn_prepare`` result where nothing is prepared: the refs as they
    are, searched by the dispatched ``knn`` (the JAX package's ``RawRefs``)."""

    def __init__(self, refs):
        self.refs = refs


def knn_prepare(refs, impl: str | None = None):
    """Prepare a ref cloud once for many ``knn_prepared`` queries, as
    ``mvpnet_tpu/ops/__init__.py::knn_prepare`` does: a cloud of at least
    2^15 refs on the card becomes a ``morton.PreparedRefs`` (Morton-sorted
    by its own real box, padded, tile boxes, the float4 layout of the
    demand-gated fusion kNN, and the raw refs for the backward); anything
    else, and every cloud under the plain versions, a ``RawRefs``."""
    if _plain(refs, impl) or not refs.is_cuda or refs.shape[1] < _knn_bucketed.MIN_N:
        return RawRefs(refs)
    return _knn_bucketed.prepare(refs)


def knn_prepared(queries, prepared, k: int, impl: str | None = None):
    """kNN against a ``knn_prepare`` result; the contract of ``knn``. A
    prepared cloud takes the fusion kernel's demand mode (only the query
    side is prepared per call); a ``RawRefs`` the dispatched ``knn``. The
    gradient is ``knn``'s, to the queries and to ``prepared.refs``."""
    if isinstance(prepared, RawRefs):
        return _knn_dispatch(queries, prepared.refs, k, impl)
    return _KnnFunction.apply(queries, prepared.refs, k, impl, prepared)
