"""Device time of FPS, ball query and three-NN at every launch of a forward, on the card.

    python3 -m mvpnet_torch.profile_levels [--paths chunk,scene,train] [--reps 20] [--out FILE]

For each path, takes the PointNet++ input points of one forward: the chunk
request at the default Config() (the numpy batch of ``entry()``), the
whole-scene forward at config #4 over ``profile_scene``'s synthetic scene (4
windows of 102,400 points), and the train step at the training config (the
first batch of the first prefetch worker's stream of ``train_entry()``'s
synthetic training set, augmented from seed 0; the same in every run). It walks
the levels as the forward does: FPS and ball query at SA1-SA4, the three-NN
at FP1-FP4; FPS rows that ``ops.fps.route`` sends to ``fps_perrow`` are left
out. Each launch is held against its plain version, then timed ``--reps``
times two ways: CUDA events around the wrapper's call (the host's enqueue
included; median), and the kernel's device time from ``torch.profiler``
(mean a launch). Where ``ops.fps.block_layout`` exists, each FPS level is
also timed on the other layouts of the block kernel that hold its row in
registers (the C entry called straight, each equal to the wrapper's
output). Prints one JSON line (the card, each path's input checksum, every
level's times and each kernel's sums) and writes it to ``--out``.

The script runs on whichever ``mvpnet_torch`` comes first on the path, so a
copy of it placed in another checkout's package times that checkout's
kernels on the same inputs.
"""
from __future__ import annotations

import argparse
import json
import statistics

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from mvpnet_torch.config import Config, load_config
from mvpnet_torch.data.pipeline import build_dataset, collate
from mvpnet_torch.data.synthetic import make_scene
from mvpnet_torch.entry import HIGHRES_CONFIG, TRAIN_CONFIG, TRAIN_OVERRIDES, example_batch, to_device
from mvpnet_torch.eval import whole_scene
from mvpnet_torch.models.pointnet2 import gather_points
from mvpnet_torch.ops import KERNELS, _cuda, reference
from mvpnet_torch.profile_request import _device_ms, card_line
from mvpnet_torch.profile_scene import SCENE
from mvpnet_torch.train.step import prepare_batch

PATHS = ("chunk", "scene", "train")
# each wrapper's device kernel
SYMBOLS = {"fps": "fps_shared_kernel", "ball_query": "ball_query_kernel", "knn": "knn_brute_kernel"}


def path_points(path: str):
    """(config, the (B, N, 3) input points of one forward on ``path``)."""
    if path == "chunk":
        cfg = Config()
        batch = example_batch(np.random.default_rng(0), B=1, N=cfg.data.num_points, V=cfg.data.num_views_eval,
                              H=cfg.data.image_height, W=cfg.data.image_width)
        prepared = prepare_batch(cfg, to_device(batch, "cuda"), training=False)
    elif path == "train":
        cfg = load_config(TRAIN_CONFIG, TRAIN_OVERRIDES)
        data = build_dataset(cfg.data, batch_size=cfg.train.batch_size, training=True, seed=0)
        first = to_device(next(data.worker_iter(0)), "cuda")
        prepared = prepare_batch(cfg, first, training=True, generator=torch.Generator().manual_seed(0))
    else:
        cfg = load_config(HIGHRES_CONFIG)
        scene = make_scene(**SCENE)
        centers = whole_scene.enumerate_chunk_centers(scene.points, cfg.data.chunk_size, cfg.data.chunk_stride)
        samples = list(whole_scene._iter_scene_samples(scene, cfg, centers, 0))
        for s in samples:
            s.pop("point_idx")
            s.pop("colors")
        prepared = prepare_batch(cfg, to_device(collate(samples), "cuda"), training=False)
    return cfg, prepared["points"].float().contiguous()


def levels(cfg, pts) -> list[dict]:
    """Every launch of FPS (block kernel), ball query and three-NN in one
    forward's PointNet++ on ``pts``, in the forward's order of levels: FP i
    interpolates SA i's centers onto SA i-1's points (FP1 onto the input
    points); the centers come from the kernels. Each launch: ``kernel``,
    ``level``, ``shape``, its ``args`` (fps: points, npoint; ball_query:
    centers, points, radius, nsample; knn: queries, refs), ``run`` and
    ``plain`` (the wrapper's and the plain version's call)."""
    fps, bq, brute = (KERNELS[k] for k in ("fps", "ball_query", "knn"))
    out = []
    xyzs = [pts]
    for i, sa in enumerate(cfg.model.pn2.sa, 1):
        xyz = xyzs[-1]
        B, N = xyz.shape[0], xyz.shape[1]
        if fps.route(N, fps.shared_bytes(xyz.device)) == "fps":
            args = (xyz, sa.npoint)
            out.append(dict(kernel="fps", level=f"SA{i}", shape=f"{B}x{N} points -> {sa.npoint}", args=args,
                            run=lambda a=args: fps.farthest_point_sample(*a),
                            plain=lambda a=args: reference.farthest_point_sample(*a)))
        new = gather_points(xyz, fps.farthest_point_sample(xyz, sa.npoint))
        args = (new, xyz, sa.radius, sa.nsample)
        out.append(dict(kernel="ball_query", level=f"SA{i}",
                        shape=f"{B}x{new.shape[1]} centers over {N} points, r={sa.radius}, K={sa.nsample}", args=args,
                        run=lambda a=args: bq.ball_query(*a), plain=lambda a=args: reference.ball_query(*a)))
        xyzs.append(new)
    for i in range(1, len(xyzs)):
        d, s = xyzs[i - 1], xyzs[i]
        args = (d, s, 3)
        out.append(dict(kernel="knn", level=f"FP{i}", shape=f"{d.shape[0]}x{d.shape[1]} queries over {s.shape[1]} refs, k=3",
                        args=args, run=lambda a=args: brute.knn(*a), plain=lambda a=args: reference.knn(*a)))
    return out


def events_ms(fn, reps: int) -> float:
    """Median ms of ``fn`` between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, symbol: str, reps: int, attempts: int = 3) -> float:
    """Mean device ms a launch of the kernel ``symbol`` over ``reps`` calls
    of ``fn``, from torch.profiler, over the launches it recorded. The
    profiler may miss a launch at the edge of its window, and now and then
    a whole window: a window that recorded fewer than half the launches is
    profiled again, up to ``attempts`` times."""
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evts = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA and symbol in e.key]
        n = sum(e.count for e in evts)
        if n >= reps // 2:
            return sum(_device_ms(e) for e in evts) / n
    raise SystemExit(f"profile_levels: {n} launches of {symbol} profiled for {reps} calls, {attempts} times")


def equal(got, want) -> bool:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return all(torch.equal(g, w) for g, w in zip(got, want))


def fps_layouts(xyz, npoint: int, want, reps: int) -> dict | None:
    """Device ms of the block FPS on each layout (threads x points a thread)
    that holds the row in registers, and on the wrapper's; None where the
    tree has no block_layout."""
    fps = KERNELS["fps"]
    if not hasattr(fps, "block_layout"):
        return None
    B, N, _ = xyz.shape
    layouts = {tuple(fps.block_layout(N))[:2]}
    most = 1
    while most <= fps.BLOCK_POINTS:  # block_layout's rule at `most` points a thread
        t = min(fps.BLOCK_THREADS, 32 * max(1, -(-N // (32 * most))))
        p = min(most, 1 << (-(-N // t) - 1).bit_length())
        if p * t >= N:
            layouts.add((p, t))
        most *= 2
    fn = _cuda.function("fps", "fps")
    out = {}
    for p, t in sorted(layouts, key=lambda pt: pt[1]):
        got = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)

        def run(p=p, t=t, got=got):
            _cuda.launch(fn, xyz.data_ptr(), None, B, N, npoint, p, t, got.data_ptr(), _cuda.stream(xyz))

        run()
        if not torch.equal(got, want):
            raise SystemExit(f"profile_levels: fps layout {t}x{p} at {B}x{N} -> {npoint} differs from the wrapper")
        out[f"{t}x{p}"] = device_ms(run, SYMBOLS["fps"], reps)
    return out


def profile_path(path: str, reps: int) -> dict:
    cfg, pts = path_points(path)
    rows = []
    for lv in levels(cfg, pts):
        got = lv["run"]()
        if not equal(got, lv["plain"]()):
            raise SystemExit(f"profile_levels: {path} {lv['kernel']} {lv['level']} differs from its plain version")
        row = dict(kernel=lv["kernel"], level=lv["level"], shape=lv["shape"], events_ms=events_ms(lv["run"], reps),
                   device_ms=device_ms(lv["run"], SYMBOLS[lv["kernel"]], reps))
        if lv["kernel"] == "fps":
            row["layouts_device_ms"] = fps_layouts(*lv["args"], got, reps)
        print(f"  {path} {row['kernel']} {row['level']} [{row['shape']}]: equal; events {row['events_ms']:.4f} ms, "
              f"device {row['device_ms']:.4f} ms{'; layouts ' + str(row['layouts_device_ms']) if row.get('layouts_device_ms') else ''}",
              flush=True)
        rows.append(row)
    sums = {
        k: {m: sum(r[m] for r in rows if r["kernel"] == k) for m in ("events_ms", "device_ms")} for k in SYMBOLS
    }
    return {"points_sum": float(pts.double().sum()), "points_shape": list(pts.shape), "levels": rows, "sums": sums}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--paths", default=",".join(PATHS))
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_levels needs a CUDA card")
    result = {"card": card_line(), "paths": {}}
    with torch.no_grad():
        for path in args.paths.split(","):
            if path not in PATHS:
                raise SystemExit(f"profile_levels: unknown path {path!r}; one of {PATHS}")
            result["paths"][path] = profile_path(path, args.reps)
            torch.cuda.empty_cache()
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
