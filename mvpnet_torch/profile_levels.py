"""Device time of FPS, ball query, three-NN and the fusion kNN at every launch of a forward, on the card.

    python3 -m mvpnet_torch.profile_levels [--paths chunk,scene,train] [--reps 20] [--out FILE]

For each path, takes the PointNet++ input points of one forward: the chunk
request at the default Config() (the numpy batch of ``entry()``), the
whole-scene forward at config #4 over ``SCENE``, ``chip_smoke.py``'s synthetic scene (4
windows of 102,400 points), and the train step at the training config (the
first batch of the first prefetch worker's stream of ``train_entry()``'s
synthetic training set, augmented from seed 0; the same in every run). It walks
the levels as the forward does: FPS and ball query at SA1-SA4, the three-NN
at FP1-FP4; FPS rows that ``ops.fps.route`` sends to ``fps_perrow`` are left
out; then the fusion kNN of the forward over the path's pixel cloud: row 1
in the mode its ``route`` picks (and in its demand mode where that is
brute), and rows 6 and 7 (the kernels of ``ops.set_fusion_variant``) on the
same search, row 6 on the train and scene paths and row 7 on the train path
(the scene's cloud is past its cap), each held on the first 256 queries of
each row. For each of them the device time of every kernel a call launches
is also taken (``device_all_ms``: the prep's and the search's;
``prep_device_ms`` is the difference); for rows 6 and 7, where the tree has
``knn_at``, each layout of lanes 1 to 32 is timed (each equal to the
wrapper's output), and where ``chip_smoke.need_pairs`` is found, the pairs
the inputs need (``need_pairs``, the bound's count) go beside them. Each
launch is held against its plain version, then timed ``--reps`` times two
ways: CUDA events around the wrapper's call (the host's enqueue
included; median), and the kernel's device time from ``torch.profiler``
(mean a launch). Where ``ops.fps.block_layout`` exists, each FPS level is
also timed on the other layouts of the block kernel that hold its row in
registers (the C entry called straight, each equal to the wrapper's
output); where ``ops.knn.layout`` exists, each three-NN level on every
(lanes a query, queries a thread) that fits its tile (``knn_at``, each equal
to the wrapper's output). Prints one JSON line (the card, each path's input
checksum, every level's times and each kernel's sums) and writes it to
``--out``.

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
from mvpnet_torch.train.step import prepare_batch

PATHS = ("chunk", "scene", "train")
# each wrapper's device kernels (the fusion kNN's by its mode)
SYMBOLS = {"fps": ("fps_shared_kernel",), "ball_query": ("ball_query_kernel",), "knn": ("knn_brute_kernel",),
           "knn_gated": ("knn_gated_kernel",), "knn_resident": ("knn_resident_kernel",)}
FUSION_SYMBOLS = {"brute": ("knn_slice_kernel", "knn_merge_kernel"), "demand": ("knn_demand_kernel",)}
FUSION_SUBSET = 256  # queries of each row of a fusion search held against the plain version
# the scene path's scene: seed 0, 300,000 points, 96 frames, a 6 m room
SCENE = dict(seed=0, num_points=300_000, num_frames=96, room=6.0)


def path_points(path: str):
    """(config, the (B, N, 3) input points of one forward on ``path``, its
    (B, V*H*W, 3) pixel cloud)."""
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
        samples = list(whole_scene._iter_scene_samples(scene, cfg, whole_scene.scene_windows(scene, cfg), 0))
        for s in samples:
            s.pop("point_idx")
            s.pop("colors")
        prepared = prepare_batch(cfg, to_device(collate(samples), "cuda"), training=False)
    pts = prepared["points"].float().contiguous()
    return cfg, pts, prepared["image_xyz"].reshape(pts.shape[0], -1, 3).contiguous()


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


def fusion_levels(cfg, pts, pix, path: str) -> list[dict]:
    """The fusion kNN of one forward on ``pts`` over the pixel cloud
    ``pix``: row 1 in its route's mode, and rows 6 (train and scene paths)
    and 7 (train path) on the same search; as ``levels``, with the device
    kernels (``symbols``) and ``subset``, the queries of each row that
    ``plain`` gives (its plain version cannot run the full search)."""
    k = cfg.model.aggregation.k
    B, M, N = pts.shape[0], pts.shape[1], pix.shape[1]
    mode = KERNELS["knn_fusion"].route(B, M, N)
    sub = pts[:, :FUSION_SUBSET].contiguous()
    rows = torch.arange(FUSION_SUBSET, device=pts.device)
    fusion = KERNELS["knn_fusion"]
    # row 1 in its route's mode, and where that is brute, in its demand mode
    # too (with its plain-PyTorch prep: where the modes would cross)
    out = [dict(kernel="knn_fusion", level=m, symbols=FUSION_SYMBOLS[m], plain=lambda: reference.knn(sub, pix, k),
                run=lambda m=m: fusion.knn(pts, pix, k, mode=m))
           for m in dict.fromkeys((mode, "demand"))]
    variants = {"train": ("knn_gated", "knn_resident"), "scene": ("knn_gated",)}.get(path, ())
    out += [dict(kernel=name, level="variant", symbols=SYMBOLS[name],
                 plain=lambda mod=KERNELS[name]: mod.plain(pts, pix, k, rows=rows),
                 run=lambda mod=KERNELS[name]: mod.knn(pts, pix, k))
            for name in variants]
    for lv in out:
        lv.update(shape=f"{B}x{M} queries over {N} refs, k={k}", subset=FUSION_SUBSET)
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


def device_ms(fn, symbols: tuple, reps: int, attempts: int = 3) -> float:
    """Device ms a call of ``fn`` spends in the kernels ``symbols``: for
    each, its mean over the launches torch.profiler recorded in ``reps``
    calls; their sum. The profiler may miss a launch at the edge of its
    window, and now and then a whole window: a window that recorded fewer
    than half the launches of a kernel is profiled again, up to
    ``attempts`` times."""
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        means = []
        for symbol in symbols:
            evts = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA and symbol in e.key]
            n = sum(e.count for e in evts)
            if n < reps // 2:
                break
            means.append(sum(_device_ms(e) for e in evts) / n)
        else:
            return sum(means)
    raise SystemExit(f"profile_levels: {n} launches of {symbol} profiled for {reps} calls, {attempts} times")


def device_all_ms(fn, reps: int) -> float:
    """Device ms of every kernel, copy and fill a call of ``fn`` launches
    (torch.profiler, the sum over ``reps`` calls over ``reps``)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(_device_ms(e) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)) / reps


def gated_tiles(name: str, M: int, N: int) -> tuple[int, int]:
    mod = KERNELS[name]
    return mod.tiles(M, N)[:2] if name == "knn_gated" else mod.tiles(M)


def gated_layouts(name: str, pts, pix, k: int, want, reps: int) -> dict | None:
    """Device ms of a gated kernel's search on each layout, lanes 1 to 32
    with the rows a block its rule gives; None where the tree has no
    ``knn_at``."""
    mod, gated = KERNELS[name], KERNELS["knn_gated"]
    if not hasattr(mod, "knn_at"):
        return None
    tile_m = gated_tiles(name, pts.shape[1], pix.shape[1])[0]
    out = {}
    lanes = 1
    while lanes <= gated.MAX_LANES:
        rows = min(tile_m, gated.MAX_THREADS // lanes)

        def run(lanes=lanes, rows=rows):
            return mod.knn_at(pts, pix, k, lanes, rows)

        if not equal(run(), want):
            raise SystemExit(f"profile_levels: {name} layout {lanes}x{rows} differs from the wrapper")
        out[f"{lanes}x{rows}"] = device_ms(run, SYMBOLS[name], reps)
        lanes *= 2
    return out


def need(name: str, pts, pix, k: int, got) -> dict | None:
    """chip_smoke.need_pairs on the search's prep tiles (the gated kernels'
    bound), with the pairs the kernel's gates let through; None where this
    checkout's chip_smoke.py has no need_pairs."""
    try:
        from chip_smoke import need_pairs
    except ImportError:
        return None
    from mvpnet_torch.ops import morton

    tile_m, tile_n = gated_tiles(name, pts.shape[1], pix.shape[1])
    r_sorted = morton.prepare(pts, pix, tile_m, tile_n).r_sorted
    pairs, per_row = need_pairs(torch, pts, got[0][..., k - 1], [morton.tile_bounds(r_sorted, tile_n)], tile_n)
    scanned = torch.zeros(1, dtype=torch.int64, device=pts.device)
    KERNELS[name].knn(pts, pix, k, scanned=scanned)
    return {"need_pairs": pairs, "need_tiles_a_row": per_row, "scanned_pairs": scanned.item()}


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


def knn_layouts(d, s, k: int, want, reps: int) -> dict | None:
    """Device ms of the three-NN kernel on every layout (lanes x queries a
    thread) at the wrapper's tile; None where the tree has no layout."""
    brute = KERNELS["knn"]
    if not hasattr(brute, "layout"):
        return None
    B, M, N = d.shape[0], d.shape[1], s.shape[1]
    _, _, tile = brute.layout(B, M, N, torch.cuda.get_device_properties(d.device).multi_processor_count)
    out = {}
    lanes = 1
    while lanes <= brute.MAX_LANES and lanes * brute.QUAD <= max(tile, brute.QUAD):
        for per_thread in sorted(brute.QUERIES_PER_THREAD):
            def run(lanes=lanes, per_thread=per_thread):
                return brute.knn_at(d, s, k, lanes, per_thread, tile)

            if not equal(run(), want):
                raise SystemExit(f"profile_levels: knn layout {lanes}x{per_thread} at {B}x{M} over {N} differs")
            out[f"{lanes}x{per_thread}"] = device_ms(run, SYMBOLS["knn"], reps)
        lanes *= 2
    return out


def profile_path(path: str, reps: int) -> dict:
    cfg, pts, pix = path_points(path)
    rows = []
    for lv in levels(cfg, pts) + fusion_levels(cfg, pts, pix, path):
        got = lv["run"]()
        n = lv.get("subset")
        if not equal(got if n is None else tuple(x[:, :n] for x in got), lv["plain"]()):
            raise SystemExit(f"profile_levels: {path} {lv['kernel']} {lv['level']} differs from its plain version")
        row = dict(kernel=lv["kernel"], level=lv["level"], shape=lv["shape"], events_ms=events_ms(lv["run"], reps),
                   device_ms=device_ms(lv["run"], lv["symbols"] if "symbols" in lv else SYMBOLS[lv["kernel"]], reps))
        if lv["kernel"] == "fps":
            row["layouts_device_ms"] = fps_layouts(*lv["args"], got, reps)
        elif lv["kernel"] == "knn":
            row["layouts_device_ms"] = knn_layouts(*lv["args"], got, reps)
        if "symbols" in lv:  # a fusion search: its prep's device time apart
            row["device_all_ms"] = device_all_ms(lv["run"], reps)
            row["prep_device_ms"] = row["device_all_ms"] - row["device_ms"]
        if lv["kernel"] in ("knn_gated", "knn_resident"):
            k = cfg.model.aggregation.k
            row["layouts_device_ms"] = gated_layouts(lv["kernel"], pts, pix, k, got, reps)
            row["need"] = need(lv["kernel"], pts, pix, k, got)
        print(f"  {path} {row['kernel']} {row['level']} [{row['shape']}]: equal; events {row['events_ms']:.4f} ms, "
              f"device {row['device_ms']:.4f} ms"
              f"{'; with its prep ' + format(row['device_all_ms'], '.4f') + ' ms' if 'device_all_ms' in row else ''}"
              f"{'; layouts ' + str(row['layouts_device_ms']) if row.get('layouts_device_ms') else ''}"
              f"{'; ' + str(row['need']) if row.get('need') else ''}",
              flush=True)
        rows.append(row)
    sums = {
        k: {m: sum(r[m] for r in rows if r["kernel"] == k) for m in ("events_ms", "device_ms")}
        for k in dict.fromkeys(r["kernel"] for r in rows)
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
