"""Point-cloud ops: public API with implementation dispatch.

Counterpart of ``mvpnet_tpu/ops/__init__.py``. Every op has two versions
behind one signature:
  * the CUDA kernels (``csrc/*.cu``, wrapped by ``knn``, ``knn_bucketed``,
    ``fps`` and ``ballquery``);
  * the plain PyTorch versions (``reference``).

``set_impl`` chooses:
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
kNN) to ``knn_bucketed`` and every other search to the brute kernel, as
``mvpnet_tpu/ops/pallas/knn_bucketed.py:86-96`` does.
"""
from __future__ import annotations

from mvpnet_torch.ops import ballquery as _bq
from mvpnet_torch.ops import fps as _fps
from mvpnet_torch.ops import knn as _knn
from mvpnet_torch.ops import knn_bucketed as _knn_bucketed
from mvpnet_torch.ops import reference as _ref
from mvpnet_torch.ops.reference import group_points  # noqa: F401

_IMPLS = ("auto", "reference", "cuda")
_impl = "auto"
# wrapper module of each CUDA kernel, by kernel name. (The function ``knn``
# below shadows the submodule attribute ``ops.knn``; reach the brute
# wrapper module as ``KERNELS["knn"]``.)
KERNELS = {
    "knn_fusion": _knn_bucketed,
    "fps": _fps,
    "fps_perrow": _fps.perrow,
    "ball_query": _bq,
    "knn": _knn,
}


def set_impl(name: str) -> None:
    global _impl
    if name not in _IMPLS:
        raise ValueError(f"unknown ops impl {name!r}; expected one of {_IMPLS}")
    _impl = name


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0


def _plain(t) -> bool:
    """True when the plain version runs: explicit "reference" mode. In
    "cuda" mode a CPU tensor raises; in "auto" the wrapper decides by device."""
    if _impl == "reference":
        return True
    if _impl == "cuda" and not t.is_cuda:
        raise RuntimeError("ops impl 'cuda' needs CUDA tensors, got a CPU tensor")
    return False


def _knn_dispatch(queries, refs, k):
    if _plain(queries):
        return _ref.knn(queries, refs, k)
    if _knn_bucketed.supported(queries.shape[1], refs.shape[1]):
        return _knn_bucketed.knn(queries, refs, k)
    return _knn.knn(queries, refs, k)


def knn(queries, refs, k: int, ref_mask=None):
    """k nearest neighbors; see reference.knn. Masked refs move to the 1e9
    sentinel (as the Pallas wrappers do) before either version runs."""
    return _knn_dispatch(queries, _ref.mask_points(refs, ref_mask), k)


def farthest_point_sample(points, npoint: int, valid_mask=None):
    """Farthest point sampling; see reference.farthest_point_sample."""
    if _plain(points):
        return _ref.farthest_point_sample(points, npoint, valid_mask)
    return _fps.farthest_point_sample(points, npoint, valid_mask)


def ball_query(centers, points, radius: float, nsample: int, valid_mask=None):
    """Fixed-K radius neighborhood; see reference.ball_query."""
    if _plain(centers):
        return _ref.ball_query(centers, points, radius, nsample, valid_mask)
    return _bq.ball_query(centers, points, radius, nsample, valid_mask)


def three_nn_interpolate(dense_xyz, sparse_xyz, sparse_feat, eps: float = 1e-8):
    """Inverse-distance-weighted 3-NN upsampling; the 3-NN search goes
    through the dispatched kNN (a kernel on the card)."""
    d2, idx = _knn_dispatch(dense_xyz, sparse_xyz, 3)
    return _ref.interpolate(d2, idx, sparse_feat, eps)


class RawRefs:
    """``knn_prepare`` result: the refs as they are. The Morton sort and tile
    bounds of the JAX package's prepared cloud come with the gated fusion kNN
    (not ported yet); until then ``knn_prepared`` searches the raw refs."""

    def __init__(self, refs):
        self.refs = refs


def knn_prepare(refs) -> RawRefs:
    """Prepare a ref cloud once for many ``knn_prepared`` queries."""
    return RawRefs(refs)


def knn_prepared(queries, prepared: RawRefs, k: int):
    """kNN against a ``knn_prepare`` result; the contract of ``knn``, and the
    same route (the fusion kernel for a large cloud on the card)."""
    return _knn_dispatch(queries, prepared.refs, k)
