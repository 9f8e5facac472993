"""Where the time of one whole-scene evaluation goes, on the card.

    python3 -m mvpnet_torch.profile_scene [--scenes 2]

Runs ``scene_entry()`` at the high-resolution config (BASELINE.json config
#4: 4 windows of 102,400 points and 64 views a forward) over the synthetic
scene of ``chip_smoke.py`` (seed 0, 300,000 points, 96 frames, a 6 m room:
4 windows, one forward). One warm-up scene, then ``--scenes`` scenes through
``predict_scene`` timed on the host clock without the profiler, with the
host's share split out: the chunk samples built alone (serially and in the
evaluator's thread pool), the forward (host clock around a synchronize),
the 2D net alone over the forward's 256 views (CUDA events), and the NN
fill. Then the same scenes under ``torch.profiler``. Prints one JSON line:
the card, those times, device busy ms per scene, the device's idle share,
device ms per scene of each port kernel and by family.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from mvpnet_torch.data.pipeline import collate
from mvpnet_torch.data.synthetic import make_scene
from mvpnet_torch.entry import scene_entry, to_device
from mvpnet_torch.eval import whole_scene
from mvpnet_torch.profile_request import breakdown, card_line
from mvpnet_torch.train.step import prepare_batch

SCENE = dict(seed=0, num_points=300_000, num_frames=96, room=6.0)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scenes", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_scene needs a CUDA card")
    _, (model, cfg) = scene_entry()
    scene = make_scene(**SCENE)
    centers = whole_scene.enumerate_chunk_centers(scene.points, cfg.data.chunk_size, cfg.data.chunk_stride)
    workers = min(cfg.data.num_workers, os.cpu_count() or 1)
    forward = whole_scene.make_forward(model, cfg)
    forward_ms: list = []

    def timed(batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = forward(batch)
        torch.cuda.synchronize()
        forward_ms.append((time.perf_counter() - t) * 1e3)
        return out

    def run() -> list[float]:
        ms = []
        for _ in range(args.scenes):
            t0 = time.perf_counter()
            whole_scene.predict_scene(model, cfg, scene, batch_size=cfg.eval.batch_size, forward_fn=timed)
            ms.append((time.perf_counter() - t0) * 1e3)
        return ms

    run()  # warm-up
    forward_ms.clear()
    scene_ms = run()
    warm_forward_ms = list(forward_ms)

    def build_ms(num_workers: int) -> tuple[float, list]:
        t0 = time.perf_counter()
        samples = list(whole_scene._iter_scene_samples(scene, cfg, centers, num_workers))
        return (time.perf_counter() - t0) * 1e3, samples

    serial_ms, samples = build_ms(0)
    pool_ms, _ = build_ms(workers)
    idx = np.stack([s.pop("point_idx") for s in samples])
    for s in samples:
        s.pop("colors")
    with torch.no_grad():
        batch = prepare_batch(cfg, to_device(collate(samples), "cuda"), training=False)
        B, V, H, W, _ = batch["images"].shape
        images = batch["images"].reshape(B * V, H, W, 3)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        model.net_2d(images)
        unet_ms = []
        for _ in range(3):
            start.record()
            model.net_2d(images)
            end.record()
            end.synchronize()
            unet_ms.append(start.elapsed_time(end))
        logits = forward(to_device(collate(samples), "cuda"))
    acc = torch.zeros((len(scene.points), cfg.data.num_classes), device="cuda")
    cnt = torch.zeros((len(scene.points),), dtype=torch.int32, device="cuda")
    whole_scene.accum_scene_logits(acc, cnt, logits, torch.from_numpy(idx).cuda())
    acc_np, cnt_np = acc.cpu().numpy(), cnt.cpu().numpy()
    t0 = time.perf_counter()
    whole_scene.nn_fill_uncovered(scene.points, acc_np, cnt_np)
    fill_ms = (time.perf_counter() - t0) * 1e3

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        traced_ms = run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    print(json.dumps({
        "card": card_line(),
        "config": "configs/scannet/mvpnet_3d_highres_64view.yaml",
        "scene": {**SCENE, "windows": len(samples), "views": V, "points_per_window": cfg.data.num_points},
        "scenes": args.scenes,
        "scene_ms": scene_ms,
        "scene_ms_median": statistics.median(scene_ms),
        "forward_ms": warm_forward_ms,
        "unet_ms": unet_ms,
        "chunk_build_ms_serial": serial_ms,
        "chunk_build_ms_pool": pool_ms,
        "pool_workers": workers,
        "nn_fill_ms": fill_ms,
        "uncovered_share": float((cnt_np == 0).mean()),
        "profiled_scene_ms": traced_ms,
        **breakdown(prof, args.scenes, wall_ms, "scene"),
    }))


if __name__ == "__main__":
    main()
