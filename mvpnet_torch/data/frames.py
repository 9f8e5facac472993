"""Frame-level 2D dataset (reference ``ScanNet2D`` equivalent).

The port's copy of ``mvpnet_tpu/data/frames.py``, pure NumPy: for the same
scenes and seed it gives the same batches byte for byte.

The reference pretrains its UNet on the FULL ScanNet 2D frame corpus with
random frame sampling and 2D augmentation (mvpnet/data/scannet_2d.py,
UNVERIFIED; SURVEY.md §2.2 "2D dataset", §3.6) — a different sampling
distribution from the chunk pipeline's view-selected frames. This module
provides that capability:

  host (this module): index every (scene, frame) pair, slice arrays — no
    geometry work;
  device (train/step.prepare_frame_batch): dequantize + 2D augmentation
    (horizontal flip + color jitter, core/augment.apply_frame_augment).

Batch layout: ``images (B, H, W, 3)``, ``seg_label_2d (B, H, W)`` — no
points/depth keys, which is how ``prepare_batch`` recognizes frame mode.
"""
from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np

from mvpnet_torch.config import DataConfig
from mvpnet_torch.data.synthetic import Scene


class FrameDataset:
    """Iterable over batched 2D frames from a set of scenes.

    Training iteration samples frames uniformly over the whole corpus;
    ``iter_epoch`` makes one deterministic in-order pass (full-corpus eval,
    cli/test_2d.py).
    """

    def __init__(
        self,
        scenes: Sequence[Scene],
        cfg: DataConfig,
        *,
        batch_size: int,
        training: bool = True,
        seed: int | None = None,
    ):
        if not len(scenes):
            raise ValueError("FrameDataset needs at least one scene")
        # lazy stores (data/scannet.SceneStore) stay lazy: frame counts come
        # from the tiny poses arrays, scenes load on demand with LRU eviction
        from mvpnet_torch.data.scannet import SceneStore, frame_count

        if isinstance(scenes, SceneStore):
            self.scenes = scenes
            counts = [frame_count(scenes.root, sid) for sid in scenes.ids]
        else:
            self.scenes = list(scenes)
            counts = [len(s.depth) for s in self.scenes]
        self.cfg = cfg
        self.batch_size = batch_size
        self.training = training
        self._seed = cfg.seed if seed is None else seed
        self.rng = np.random.default_rng(self._seed)
        # full frame corpus: every (scene_idx, frame_idx) pair
        self.index = [
            (si, fi) for si, c in enumerate(counts) for fi in range(c)
        ]
        if not self.index:
            raise ValueError("scenes contain no frames")
        self._counts = np.asarray(counts, np.int64)
        self._scene_probs = self._counts / self._counts.sum()

    def _frame(self, si: int, fi: int) -> dict:
        scene = self.scenes[si]
        if self.cfg.compact_transfer:
            image = np.clip(scene.rgb[fi] * 255.0 + 0.5, 0, 255).astype(np.uint8)
            label = scene.label_2d[fi].astype(np.int8)  # ids <128, -100 fits
        else:
            image = scene.rgb[fi].astype(np.float32)
            label = scene.label_2d[fi].astype(np.int32)
        return {
            "images": image,
            "seg_label_2d": label,
        }

    def sample(self, rng: np.random.Generator | None = None) -> dict:
        rng = rng if rng is not None else self.rng
        si, fi = self.index[rng.integers(len(self.index))]
        return self._frame(si, fi)

    def _sample_stream(self, rng) -> Iterator[dict]:
        """Locality-aware infinite sample stream: pick a scene with
        probability proportional to its frame count (so the per-frame
        marginal stays uniform over the corpus), then draw
        ``frames_per_scene_visit`` frames from it before moving on.

        Over a lazy SceneStore on a real-sized corpus, fully-uniform
        sampling makes nearly every sample decompress a whole scene's frame
        archive to slice one frame and thrashes the LRU across workers;
        visiting K frames per resident scene amortizes each load K-fold.

        A shuffle buffer re-interleaves the visit stream so one BATCH always
        mixes samples from several scene visits: without it, K >= batch_size
        (the defaults: both 8) made every batch single-scene — a silent
        shuffle-quality/BatchNorm regression vs the reference's uniform frame
        sampling. Scene loads stay sequential (one resident scene per
        worker), so the locality win is unchanged."""
        k = max(1, int(getattr(self.cfg, "frames_per_scene_visit", 1)))
        if k == 1 or len(self._counts) == 1:
            while True:
                yield self.sample(rng)

        def visits():
            while True:
                si = int(rng.choice(len(self._counts), p=self._scene_probs))
                for fi in rng.integers(self._counts[si], size=k):
                    yield self._frame(si, int(fi))

        size = max(4 * k, 2 * self.batch_size)  # ~size/k concurrent visits
        src = visits()
        buf = [next(src) for _ in range(size)]
        while True:
            j = int(rng.integers(size))
            out = buf[j]
            buf[j] = next(src)
            yield out

    def _batch(self, samples) -> dict:
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}

    def __iter__(self) -> Iterator[dict]:
        stream = self._sample_stream(self.rng)
        while True:
            yield self._batch([next(stream) for _ in range(self.batch_size)])

    def worker_iter(self, worker_id: int) -> Iterator[dict]:
        """Independent infinite batch stream for one prefetch worker (the
        same lock-free contract as ChunkDataset.worker_iter)."""
        rng = np.random.default_rng(np.random.SeedSequence([self._seed, worker_id]))
        stream = self._sample_stream(rng)
        while True:
            yield self._batch([next(stream) for _ in range(self.batch_size)])

    def iter_epoch(self) -> Iterator[dict]:
        """One deterministic in-order pass over every frame; the last batch
        is padded by repeating its final frame (``n_real`` marks real rows)."""
        for start in range(0, len(self.index), self.batch_size):
            block = self.index[start : start + self.batch_size]
            n_real = len(block)
            while len(block) < self.batch_size:
                block.append(block[-1])
            batch = self._batch([self._frame(si, fi) for si, fi in block])
            batch["n_real"] = n_real
            yield batch
