"""Whole-scene sliding-window inference + confusion-matrix evaluation.

Counterpart of ``mvpnet_tpu/eval/whole_scene.py``: slide chunk windows over
the scene (stride < chunk size), run the fusion net on each chunk with its
own greedily selected views, scatter-add the per-point logits of overlapping
chunks on the device, fill points no chunk sampled from their nearest scored
neighbour, argmax, per-class IoU / mIoU, and an optional ScanNet
benchmark-format export (20-class -> NYU40 ids).

The host builds chunk samples in a thread pool while the device runs the
forwards; the device keeps the (P, num_classes) accumulator, fills it
(``nn_fill``: on a card the brute kNN kernel, ties to the lower index), and
the host reads it once per scene. ``predict_scene``'s spans (``tracing``):
``scene.predict`` over ``scene.windows``, ``scene.chunk_wait``,
``scene.transfer``, ``scene.forward``, ``scene.accumulate``,
``scene.nn_fill`` and ``scene.readback``, and ``scene.chunk_build`` on the
pool's threads.
"""
from __future__ import annotations

import itertools
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from mvpnet_torch import ops, tracing
from mvpnet_torch.config import Config
from mvpnet_torch.data.meta import CLASS_NAMES, remap_to_nyu40
from mvpnet_torch.data.pipeline import _scene_grid_index, collate, make_chunk_sample
from mvpnet_torch.data.synthetic import Scene
from mvpnet_torch.entry import to_device
from mvpnet_torch.train.metrics import iou_from_confusion
from mvpnet_torch.train.step import prepare_batch


def enumerate_chunk_centers(points: np.ndarray, chunk_size: float, stride: float):
    """Grid of xy window centers covering the scene bbox."""
    lo = points[:, :2].min(axis=0)
    hi = points[:, :2].max(axis=0)
    xs = np.arange(lo[0] + chunk_size / 2, hi[0] + stride, stride)
    ys = np.arange(lo[1] + chunk_size / 2, hi[1] + stride, stride)
    return np.stack(np.meshgrid(xs, ys, indexing="ij"), axis=-1).reshape(-1, 2)


def occupied_centers(points: np.ndarray, centers, half: float) -> list:
    """The window centers whose (2 * half)^2 xy column holds a point."""
    out = []
    for center in centers:
        near = np.abs(points[:, :2] - center)
        if np.any((near[:, 0] <= half) & (near[:, 1] <= half)):
            out.append(center)
    return out


def accum_scene_logits(acc, cnt, logits, idx):
    """Scatter-add chunk logits onto the scene accumulator, in place.

    acc (P, C) f32 and cnt (P,) int32 on the device; logits (B, N, C), idx
    (B, N) integer. ``index_add_`` adds every duplicate index (chunk sampling
    with replacement). On the card it adds with atomics, so the order of the
    additions, and the last bits of a sum, can change from run to run."""
    flat = idx.reshape(-1).long()
    acc.index_add_(0, flat, logits.float().reshape(-1, logits.shape[-1]))
    cnt.index_add_(0, flat, torch.ones(flat.shape, dtype=cnt.dtype, device=cnt.device))
    return acc, cnt


class Evaluator:
    """Confusion-matrix accumulator -> per-class IoU / mIoU / accuracy."""

    def __init__(self, num_classes: int, ignore_label: int = -100):
        self.num_classes = num_classes
        self.ignore_label = ignore_label
        self.cm = np.zeros((num_classes, num_classes), np.int64)

    def update(self, pred: np.ndarray, label: np.ndarray):
        # in int64: the compact frames' int8 labels would wrap label * C
        pred, label = np.asarray(pred, np.int64), np.asarray(label, np.int64)
        valid = label != self.ignore_label
        idx = label[valid] * self.num_classes + pred[valid]
        self.cm += np.bincount(idx, minlength=self.num_classes**2).reshape(self.num_classes, self.num_classes)

    def results(self) -> dict:
        iou, miou = iou_from_confusion(torch.from_numpy(self.cm))
        iou = iou.numpy()
        acc = self.cm.diagonal().sum() / max(self.cm.sum(), 1)
        return {
            "miou": float(miou),
            "accuracy": float(acc),
            "class_iou": {
                CLASS_NAMES[c] if c < len(CLASS_NAMES) else str(c): float(iou[c]) for c in range(self.num_classes)
            },
        }


def nn_fill_uncovered(points: np.ndarray, logits_acc: np.ndarray, counts: np.ndarray):
    """Fill zero-count points from their nearest scored neighbor, in place.

    Chunk sampling touches only num_points per window, so some scene points
    may receive no logits; filling from the nearest scored point is standard
    ScanNet whole-scene eval practice for sampled predictions.
    Returns the number of points filled.
    """
    uncovered = counts == 0
    if uncovered.any() and (~uncovered).any():
        from scipy.spatial import cKDTree

        tree = cKDTree(points[~uncovered])
        _, nn = tree.query(points[uncovered], k=1)
        logits_acc[uncovered] = logits_acc[~uncovered][nn]
        return int(uncovered.sum())
    return 0


def nn_fill_device(points: np.ndarray, acc: torch.Tensor, cnt: torch.Tensor) -> int:
    """``nn_fill_uncovered`` on the accumulator's device, in place: acc (P, C)
    and cnt (P,) where they live, points (P, 3) on the host. The search is
    ``ops.nearest`` (the brute kNN kernel on the card) over the covered
    points in index order, so a tie goes to the lower index; a cKDTree
    leaves that order unspecified. Returns the number of points filled."""
    covered = cnt > 0
    ref_idx = covered.nonzero()[:, 0]
    query_idx = (~covered).nonzero()[:, 0]
    if not (len(query_idx) and len(ref_idx)):
        return 0
    pts = torch.from_numpy(np.ascontiguousarray(points, np.float32)).to(acc.device)
    nn = ops.nearest(pts[query_idx], pts[ref_idx])
    acc[query_idx] = acc[ref_idx[nn]]
    return len(query_idx)


def nn_fill(points: np.ndarray, acc: torch.Tensor, cnt: torch.Tensor) -> None:
    """Fill the uncovered points where the accumulator lives, in place: on a
    card ``nn_fill_device``; on the host (a CPU model) ``nn_fill_uncovered``,
    whose cKDTree is O(M log N) where a brute search on CPU cores is O(M N).
    Counts the filled points in ``scene.nn_fill_points`` while a profiler
    records."""
    if acc.is_cuda:
        n = nn_fill_device(points, acc, cnt)
    else:
        n = nn_fill_uncovered(points, acc.numpy(), cnt.numpy())
    tracing.count("scene.nn_fill_points", n)


def scene_windows(scene: Scene, cfg: Config) -> list:
    """The occupied window centers of ``scene``, in window order; builds the
    scene's grid index (``_scene_grid_index``) that chunk sampling queries."""
    centers = enumerate_chunk_centers(scene.points, cfg.data.chunk_size, cfg.data.chunk_stride)
    _scene_grid_index(scene)  # shared by the pool's threads, built once
    return occupied_centers(scene.points, centers, cfg.data.chunk_size / 2 + cfg.data.chunk_margin)


def _iter_scene_samples(scene: Scene, cfg: Config, windows, num_workers: int):
    """Yield chunk samples for the ``windows`` (``scene_windows``), in order.
    With ``num_workers > 0`` a thread pool builds them with a bounded number
    in flight, so view selection (mostly the native greedy cover, which
    releases the GIL) overlaps the device forwards; a build's span
    ``scene.chunk_build`` is a child of the span open where it was submitted."""

    def build(center, parent=None):
        with tracing.span("scene.chunk_build", parent):
            return make_chunk_sample(scene, cfg.data, center_xy=center, num_views=cfg.data.num_views_eval, rng=None)

    if num_workers <= 0:
        for center in windows:
            yield build(center)
        return

    with ThreadPoolExecutor(num_workers) as pool:
        inflight: deque = deque()
        it = iter(windows)
        for center in itertools.islice(it, 2 * num_workers):
            inflight.append(pool.submit(build, center, tracing.current()))
        while inflight:
            yield inflight.popleft().result()
            nxt = next(it, None)
            if nxt is not None:
                inflight.append(pool.submit(build, nxt, tracing.current()))


def model_device(model) -> torch.device:
    return next(model.parameters()).device


def make_forward(model, cfg: Config):
    """forward_fn(batch of device tensors) -> 3D logits (B, N, C) f32."""

    @torch.no_grad()
    def forward_fn(batch):
        logits_3d, _ = model(prepare_batch(cfg, batch, training=False))
        return logits_3d

    return forward_fn


def predict_scene(
    model,
    cfg: Config,
    scene: Scene,
    *,
    batch_size: int = 4,
    forward_fn=None,
    num_workers: int | None = None,
) -> np.ndarray:
    """Accumulated per-point logits (P, num_classes) for one scene.

    Runs on the model's device. Chunk windows go through ``forward_fn`` in
    groups of ``batch_size``; the last group runs at its own size, so every
    forward computes only real windows."""
    with tracing.span("scene.predict"):
        return _predict_scene(model, cfg, scene, batch_size, forward_fn or make_forward(model, cfg), num_workers)


def _predict_scene(model, cfg: Config, scene: Scene, batch_size: int, forward_fn, num_workers: int | None):
    device = model_device(model)
    with tracing.span("scene.windows"):
        windows = scene_windows(scene, cfg)
    P = len(scene.points)
    C = cfg.data.num_classes
    workers = min(cfg.data.num_workers, os.cpu_count() or 1) if num_workers is None else num_workers

    acc = torch.zeros((P, C), dtype=torch.float32, device=device)
    cnt = torch.zeros((P,), dtype=torch.int32, device=device)
    samples, idx_blocks = [], []

    def flush():
        if samples:
            with tracing.span("scene.transfer"):
                idx = torch.from_numpy(np.stack(idx_blocks)).to(device)
                batch = to_device(collate(samples), device)
            with tracing.span("scene.forward"):
                logits = forward_fn(batch)
            with tracing.span("scene.accumulate"):
                accum_scene_logits(acc, cnt, logits, idx)
            samples.clear()
            idx_blocks.clear()

    chunks = _iter_scene_samples(scene, cfg, windows, workers)
    while True:
        with tracing.span("scene.chunk_wait"):
            s = next(chunks, None)
        if s is None:
            break
        idx_blocks.append(s.pop("point_idx"))
        if not cfg.data.include_colors:
            s.pop("colors", None)
        samples.append(s)
        if len(samples) == batch_size:
            flush()
    flush()

    with tracing.span("scene.nn_fill"):
        nn_fill(scene.points, acc, cnt)
    with tracing.span("scene.readback"):
        return acc.cpu().numpy()


def evaluate_scenes(
    model,
    cfg: Config,
    scenes,
    *,
    batch_size: int = 4,
    export_dir: str | None = None,
    mesh=None,
    fused: bool = False,
) -> dict:
    """Per-scene prediction, confusion matrix and optional benchmark export.

    With a ``mesh`` (``dist/mesh.py``: a process mesh or the loopback
    one), scenes go through the space-sharded estimator
    (eval/sharded_scene.py); with ``fused``, through the single-device
    scene-view-set estimator (eval/scene_fused.py); otherwise through
    ``predict_scene``."""
    model.eval()
    evaluator = Evaluator(cfg.data.num_classes, cfg.data.ignore_label)
    if mesh is not None:
        from mvpnet_torch.eval.sharded_scene import build_sharded_scene_fns, predict_scene_sharded

        sharded_fns = build_sharded_scene_fns(model, cfg, mesh)
    elif fused:
        from mvpnet_torch.eval.scene_fused import build_scene_fused_fns, predict_scene_fused

        fused_fns = build_scene_fused_fns(model, cfg)
    else:
        forward_fn = make_forward(model, cfg)

    for scene in scenes:
        if mesh is not None:
            logits = predict_scene_sharded(model, cfg, scene, mesh, fns=sharded_fns)
        elif fused:
            logits = predict_scene_fused(model, cfg, scene, fns=fused_fns)
        else:
            logits = predict_scene(model, cfg, scene, batch_size=batch_size, forward_fn=forward_fn)
        pred = logits.argmax(axis=1)
        evaluator.update(pred, scene.labels)
        if export_dir:
            os.makedirs(export_dir, exist_ok=True)
            nyu = remap_to_nyu40(pred.astype(np.int64), cfg.data.ignore_label)
            np.savetxt(os.path.join(export_dir, f"{scene.name}.txt"), nyu, fmt="%d")
    return evaluator.results()
