"""Chunk dataset, dataset factory and device prefetch.

The port's counterpart of ``mvpnet_tpu/data/pipeline.py``:
  host (this module): chunk point sampling, greedy view selection, array
    slicing, in NumPy, in a small thread pool;
  device (``mvpnet_torch.train.step.prepare_batch`` and the model):
    dequantization, the lift, augmentation, the fusion kNN.

Samples are fixed-shape: N points sampled with replacement, V views, HxW
images. Batches cross to the device through ``PrefetchIterator``: pinned
host memory, ``non_blocking`` copies, the next batch's copy issued before
the current one is handed out; with ``pack`` the whole batch is one byte
buffer and one copy.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Sequence

import numpy as np
import torch

from mvpnet_torch import tracing
from mvpnet_torch.config import DataConfig
from mvpnet_torch.data.synthetic import Scene, make_scene
from mvpnet_torch.data.view_select import select_views_for_chunk


def _scene_grid_index(scene: Scene, cell: float = 0.75):
    """Per-scene native CSR grid index, cached on the scene (data/native.py)."""
    from mvpnet_torch.data.native import GridIndex

    gi = scene.extra.get("grid_index")
    if gi is None:
        gi = GridIndex(scene.points, cell=cell)
        scene.extra["grid_index"] = gi
    return gi


def sample_chunk_points(
    scene: Scene,
    center_xy: np.ndarray,
    num_points: int,
    chunk_size: float,
    margin: float,
    rng: np.random.Generator | None,
) -> np.ndarray:
    """Find points inside a (chunk_size+2*margin)^2 xy column and sample
    exactly ``num_points`` indices (with replacement when short)."""
    half = chunk_size / 2 + margin
    idx = _scene_grid_index(scene).query_box(center_xy, half)
    if len(idx) == 0:
        idx = np.arange(len(scene.points))
    if rng is None:
        if len(idx) <= num_points:
            sel = idx[np.arange(num_points) % len(idx)]
        else:
            # deterministic but unbiased subsample (fixed seed): truncating in
            # storage order would systematically drop the tail of dense windows
            sel = np.random.default_rng(0xC0FFEE).choice(idx, num_points, replace=False)
    else:
        sel = rng.choice(idx, num_points, replace=len(idx) < num_points)
    return sel


def make_chunk_sample(
    scene: Scene,
    cfg: DataConfig,
    *,
    center_xy: np.ndarray | None = None,
    num_views: int | None = None,
    rng: np.random.Generator | None = None,
) -> dict:
    """Assemble one fixed-shape chunk sample (host side, NumPy).

    Returns dict of arrays:
      points (N,3) f32, colors (N,3) f32, seg_label (N,) i32,
      images (V,H,W,3) f32, depth (V,H,W) f32, poses (V,4,4) f32,
      intrinsics (3,3) f32, seg_label_2d (V,H,W) i32, point_idx (N,) i64.
    With ``cfg.compact_transfer`` the wire format is compact instead: uint8
    images, uint16 millimeter depth, int16 millimeter points, int8 labels
    (``prepare_batch`` dequantizes them on the device).
    """
    V = num_views or cfg.num_views_train
    if center_xy is None:
        labeled = np.nonzero(scene.labels != cfg.ignore_label)[0]
        pool = labeled if len(labeled) else np.arange(len(scene.points))
        pick = rng.choice(pool) if rng is not None else pool[0]
        center_xy = scene.points[pick, :2]

    sel = sample_chunk_points(scene, center_xy, cfg.num_points, cfg.chunk_size, cfg.chunk_margin, rng)
    chunk_pts = scene.points[sel]

    num_frames = len(scene.depth)
    candidates = None
    if num_frames > cfg.max_candidate_frames:
        candidates = (
            rng.choice(num_frames, cfg.max_candidate_frames, replace=False)
            if rng is not None
            else np.arange(cfg.max_candidate_frames)
        )
    with tracing.span("data.view_select"):
        frames = select_views_for_chunk(
            chunk_pts,
            scene.depth,
            scene.poses,
            scene.intrinsics,
            V,
            candidate_frames=candidates,
            rng=rng,
        )

    if cfg.compact_transfer:
        # points as int16 mm: +-32.7 m range, 0.5 mm quantization; class ids
        # < 128 and ignore_label=-100 fit int8
        images = np.clip(scene.rgb[frames] * 255.0 + 0.5, 0, 255).astype(np.uint8)
        depth = np.clip(scene.depth[frames] * 1000.0 + 0.5, 0, 65535).astype(np.uint16)
        points = np.clip(np.round(chunk_pts * 1000.0), -32767, 32767).astype(np.int16)
        seg_label = scene.labels[sel].astype(np.int8)
        seg_label_2d = scene.label_2d[frames].astype(np.int8)
    else:
        images = scene.rgb[frames].astype(np.float32)
        depth = scene.depth[frames].astype(np.float32)
        points = chunk_pts.astype(np.float32)
        seg_label = scene.labels[sel].astype(np.int32)
        seg_label_2d = scene.label_2d[frames].astype(np.int32)
    return {
        "points": points,
        "colors": scene.colors[sel].astype(np.float32),
        "seg_label": seg_label,
        "images": images,
        "depth": depth,
        "poses": scene.poses[frames].astype(np.float32),
        "intrinsics": scene.intrinsics.astype(np.float32),
        "seg_label_2d": seg_label_2d,
        "point_idx": sel.astype(np.int64),
    }


def collate(samples: Sequence[dict]) -> dict:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class ChunkDataset:
    """Iterable over batched chunk samples from a set of scenes."""

    def __init__(self, scenes: Sequence[Scene], cfg: DataConfig, *, batch_size: int, training: bool = True,
                 seed: int | None = None):
        if not len(scenes):
            raise ValueError("ChunkDataset needs at least one scene")
        # keep lazy stores (data/scannet.SceneStore) as they are; list()
        # would load every scene
        self.scenes = scenes if hasattr(scenes, "__getitem__") else list(scenes)
        self.cfg = cfg
        self.batch_size = batch_size
        self.training = training
        self._seed = cfg.seed if seed is None else seed
        self.rng = np.random.default_rng(self._seed)

    def sample(self, rng: np.random.Generator | None = None) -> dict:
        rng = rng if rng is not None else self.rng
        scene = self.scenes[rng.integers(len(self.scenes))]
        V = self.cfg.num_views_train if self.training else self.cfg.num_views_eval
        s = make_chunk_sample(scene, self.cfg, num_views=V, rng=rng)
        # chunk batches never consume these on the device (point colors are
        # an ablation input, point_idx a host-side eval artifact)
        s.pop("point_idx", None)
        if not self.cfg.include_colors:
            s.pop("colors", None)
        return s

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield collate([self.sample() for _ in range(self.batch_size)])

    def worker_iter(self, worker_id: int) -> Iterator[dict]:
        """Independent infinite batch stream for one prefetch worker: a private
        Generator from (seed, worker_id), no shared state."""
        rng = np.random.default_rng(np.random.SeedSequence([self._seed, worker_id]))
        while True:
            yield collate([self.sample(rng) for _ in range(self.batch_size)])


def build_dataset(cfg: DataConfig, *, batch_size: int, training: bool, seed: int = 0):
    """``cfg.name == "synthetic"``: procedural scenes; ``"scannet"``:
    preprocessed scenes from ``cfg.root`` (``data/scannet.py``), loaded
    lazily. ``cfg.sampling == "chunks"`` gives a ``ChunkDataset``,
    ``"frames"`` a ``data/frames.FrameDataset`` (2D pretraining)."""
    if cfg.sampling not in ("chunks", "frames"):
        raise ValueError(f"unknown sampling mode {cfg.sampling!r}")
    if cfg.name == "synthetic":
        n_scenes = cfg.synthetic_scenes if training else max(cfg.synthetic_scenes // 2, 2)
        scenes = [
            make_scene(
                # train and val seeds interleave (even train, odd val), so
                # the splits stay disjoint for any scene count
                seed=seed * 1_000_000 + 2 * i + (0 if training else 1),
                height=cfg.image_height,
                width=cfg.image_width,
                num_classes=cfg.num_classes,
                num_objects=cfg.synthetic_objects,
                ignore_label=cfg.ignore_label,
            )
            for i in range(n_scenes)
        ]
    elif cfg.name == "scannet":
        from mvpnet_torch.data.scannet import load_scenes

        scenes = load_scenes(cfg.root, split="train" if training else "val", lazy=True, capacity=cfg.cache_scenes)
    else:
        raise ValueError(f"unknown dataset {cfg.name!r}")
    if cfg.sampling == "frames":
        from mvpnet_torch.data.frames import FrameDataset

        return FrameDataset(scenes, cfg, batch_size=batch_size, training=training, seed=seed)
    return ChunkDataset(scenes, cfg, batch_size=batch_size, training=training, seed=seed)


def pack_batch(batch: dict):
    """Concatenate every array's bytes into one uint8 vector (each start
    8-byte aligned) with its layout ``((key, dtype str, shape, offset,
    nbytes), ...)``; non-array values come back apart (``extras``)."""
    layout, parts, extras = [], [], {}
    off = 0
    for k in sorted(batch):
        v = batch[k]
        if not isinstance(v, np.ndarray):
            extras[k] = v
            continue
        raw = np.ascontiguousarray(v).reshape(-1).view(np.uint8)
        pad = (-off) % 8
        if pad:
            parts.append(np.zeros(pad, np.uint8))
            off += pad
        layout.append((k, v.dtype.str, v.shape, off, raw.size))
        parts.append(raw)
        off += raw.size
    packed = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    return packed, tuple(layout), extras


def unpack_batch(packed: torch.Tensor, layout) -> dict:
    """Views of a packed uint8 tensor (on any device) as the arrays of
    ``layout``, with their dtypes and shapes; no copy."""
    out = {}
    for k, dstr, shape, off, size in layout:
        dt = torch.from_numpy(np.zeros(0, np.dtype(dstr))).dtype
        out[k] = packed[off : off + size].view(dt).reshape(shape)
    return out


class _WorkerError:
    """A producer thread's exception, carried to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


_END = object()  # a producer's stream is exhausted


class PrefetchIterator:
    """Background-thread batch producer and consumer-side device copy.

    Worker threads build host batches only. The consumer (``__next__``)
    copies a batch to ``device`` from pinned memory with ``non_blocking``
    copies and issues the next batch's copy before it returns, so the copy
    overlaps the caller's step (a copy and the step that reads it run in
    order on the current stream). With ``pack`` a batch is one buffer and
    one copy (``pack_batch``; dict batches only). A source with
    ``worker_iter(worker_id)`` (``ChunkDataset``) gives each thread its own
    batch stream, so the threads share no state; any other iterable is one
    stream that the threads take in turn behind a lock, so its batches come
    out in its order. A batch that is not a dict (a tuple, a list, an array)
    crosses element by element in the same structure. ``put_fn`` (a host
    batch -> the device batch) replaces the transfer, as JAX's mesh mode
    does (``train/loop.py`` cuts each batch to the rank's arrays with it);
    packing is off then. A producer's exception is raised by ``__next__``;
    ``close()`` stops and joins the threads."""

    def __init__(
        self, source, prefetch: int = 2, num_threads: int = 4, device=None, pack: bool = False, put_fn=None
    ):
        self._queue: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._device = torch.device(device) if device is not None else torch.device("cpu")
        self._put_fn = put_fn
        self._pack = pack and put_fn is None  # the rank's arrays are cut per key
        self._ready = None  # the transferred-ahead batch
        self._ready_exc = None  # a failure of that transfer, raised next call
        self._stop = threading.Event()
        per_worker = hasattr(source, "worker_iter")
        self._shared = None if per_worker else iter(source)
        self._lock = threading.Lock()
        self._threads = [
            threading.Thread(target=self._worker, args=(source.worker_iter(i) if per_worker else None,), daemon=True)
            for i in range(num_threads)
        ]
        for t in self._threads:
            t.start()

    def _enqueue(self, item) -> None:
        # a bounded put that gives up once closed, so a worker blocked on a
        # full queue cannot outlive close()
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def _produce(self, batches) -> None:
        """Build one batch and queue it (spans ``data.build``, ``data.put_wait``)."""
        with tracing.span("data.build"):
            item = next(batches)
        with tracing.span("data.put_wait"):
            self._enqueue(item)

    def _worker(self, batches):
        try:
            while not self._stop.is_set():
                if batches is not None:
                    self._produce(batches)
                else:
                    # the shared stream: taken and queued under one lock, so
                    # its order holds and the end comes after its last batch
                    with self._lock:
                        self._produce(self._shared)
        except StopIteration:
            self._enqueue(_END)
        except BaseException as e:  # carried to the consumer
            self._enqueue(_WorkerError(e))

    def __iter__(self):
        return self

    def _to_device(self, arr) -> torch.Tensor:
        t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(arr))
        if self._device.type == "cuda" and t.device.type == "cpu":
            return t.pin_memory().to(self._device, non_blocking=True)
        return t.to(self._device)

    def _put(self, x):
        """Arrays and tensors to the device, in the structure of dicts,
        tuples (named ones too) and lists around them; anything else as it
        is."""
        if isinstance(x, (np.ndarray, torch.Tensor)):
            return self._to_device(x)
        if isinstance(x, dict):
            return {k: self._put(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(self._put(v) for v in x))
        if isinstance(x, (tuple, list)):
            return type(x)(self._put(v) for v in x)
        return x

    def _transfer(self, item):
        if item is _END or isinstance(item, _WorkerError):
            return item
        if self._put_fn is not None:
            return self._put_fn(item)
        if self._pack and isinstance(item, dict):
            packed, layout, extras = pack_batch(item)
            out = unpack_batch(self._to_device(packed), layout)
            out.update(extras)
            return out
        return self._put(item)

    def __next__(self):
        with tracing.span("data.next"):
            return self._next()

    def _next(self):
        if self._ready_exc is not None:
            exc, self._ready_exc = self._ready_exc, None
            self.close()
            raise exc
        if self._ready is not None:
            item, self._ready = self._ready, None
        else:
            with tracing.span("data.queue_wait"):
                item = self._queue.get()
            with tracing.span("data.transfer"):
                item = self._transfer(item)
        if item is _END:
            raise StopIteration
        if isinstance(item, _WorkerError):
            self.close()
            raise RuntimeError("prefetch worker failed") from item.exc
        # issue the next batch's copy now; a failure there must not lose the
        # current batch, so it is raised by the next call
        try:
            ahead = self._queue.get_nowait()
        except queue.Empty:
            return item
        try:
            with tracing.span("data.transfer"):
                self._ready = self._transfer(ahead)
        except BaseException as e:
            self._ready_exc = e
        return item

    def close(self) -> None:
        self._stop.set()
        self._ready = None
        # drain, so producers blocked on put() see the stop event
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        for t in self._threads:
            t.join(timeout=2.0)
