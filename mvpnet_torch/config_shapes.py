"""Configs #3 and #4 at their shapes: training steps and the fused scene's stages.

    python -m mvpnet_torch.config_shapes [--only 3|4] [--device cpu] [--name config_shapes] \\
        [--out-dir runs/torch_config_shapes] [key=value ...]

Counterpart of ``tools/config_shapes_bench.py``. Prints one JSON line and
writes it to ``<out-dir>/<name>.json`` with JAX's keys where they apply:

  * ``config3``: BASELINE config #3 (``configs/scannet/mvpnet_3d_32k_chunks.yaml``
    on synthetic data: B=32 as 4 x B8 by ``train.grad_accum``, N=32,768, V=3
    views of 120x160) as real training steps on the numpy batch of
    ``entry.example_batch`` (seed 0) from seeded weights, with ``train.remat``
    off (``base``) and on (``remat``): the first step's seconds, the median
    step ms over ``STEPS`` steps on the host clock ending in a synchronize,
    chunks/s, the loss and the peak device memory. ``donate`` is recorded as
    not applicable: eager PyTorch has no buffer donation (the config accepts
    ``train.donate`` and nothing reads it). Then ``ENTRY_STEPS`` steps of
    the same config through ``entry.train_entry`` on synthetic scenes, the
    data pipeline's wait apart (``train_entry``);
  * ``config4_train``: config #4's (``mvpnet_3d_highres_64view.yaml``) training
    microbatch, B=2, N=102,400, V=8, ``base`` and ``remat`` as above;
  * ``config4``: config #4's fused whole-scene estimator
    (``eval/scene_fused.predict_scene_fused``) on a synthetic scene of
    ``SCENE_POINTS`` points and ``SCENE_FRAMES`` frames, all of them views:
    the warm and the timed scene seconds, then its stages apart (the lift and
    2D net of ``pixel_fn``, the cloud's ``knn_prepare``, ``fuse_fn`` on one
    chunk window), the chunk count, the peak memory and the logits' shape.

Every training step must launch each kernel as ``expected_launches`` says
(on the card; on the CPU the plain versions launch none); ``fusion_mode`` is
the fusion kNN's mode (``knn_bucketed.route``) at the shape. At config #3 a
step launches the fusion kNN 4 times, in its demand mode, ``fps_perrow`` 4 (SA1's
32,768-point rows), ``fps`` 12, the ball query 16 and the three-NN 16. A step
that launches otherwise, or a non-finite loss, raises. On the card
``config3`` also records how many of ``fps_perrow``'s clusters the card holds
at once (``fps.cluster_occupancy``) against the rows of a microbatch.

Trailing ``key=value`` overrides apply to every config (the tests' tiny
widths). Runs on CUDA unless ``--device cpu``; without CUDA it raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import time

import numpy as np
import torch

from mvpnet_torch import ops
from mvpnet_torch.config import Config, load_config
from mvpnet_torch.e2e_run import card_line
from mvpnet_torch.entry import HIGHRES_CONFIG, example_batch, resolve_device, to_device

CONFIG3 = os.path.join(os.path.dirname(HIGHRES_CONFIG), "mvpnet_3d_32k_chunks.yaml")
CONFIG4 = HIGHRES_CONFIG
SYNTHETIC = ["data.name=synthetic"]
# tools/config_shapes_bench.py's counts: timed steps a variant (after one
# untimed), timed train_entry steps, the fused scene's points and frames
STEPS = 5
ENTRY_STEPS = 3
SCENE_POINTS = 300_000
SCENE_FRAMES = 64
DONATE = {
    "applicable": False,
    "note": "eager PyTorch has no buffer donation; the config accepts train.donate and nothing reads it",
}


def expected_launches(cfg: Config, shared_bytes: int) -> dict:
    """Kernel launches of one training microbatch of ``cfg``'s
    ``mvpnet_3d`` on the card, where a block may take ``shared_bytes`` of
    dynamic shared memory: the fusion kNN once when the pixel cloud takes it
    (``knn_bucketed.supported``), else the brute kNN; per SA level one FPS
    (``fps`` or ``fps_perrow`` by ``fps.route`` of the level's input row) and
    one ball query; per FP level one three-NN (brute kNN). The backward
    launches none."""
    from mvpnet_torch.ops import fps, knn_bucketed

    d = cfg.data
    counts = dict.fromkeys(ops.KERNELS, 0)
    fusion = knn_bucketed.supported(d.num_points, d.num_views_train * d.image_height * d.image_width)
    counts["knn_fusion" if fusion else "knn"] += 1
    n = d.num_points
    for sa in cfg.model.pn2.sa:
        counts[fps.route(n, shared_bytes)] += 1
        counts["ball_query"] += 1
        counts["knn"] += 1  # the FP level of the same depth
        n = sa.npoint
    return counts


def fusion_mode(cfg: Config, rows: int) -> str | None:
    """The fusion kNN's mode (``knn_bucketed.route``) of a training
    microbatch of ``rows`` chunks, None when the brute kNN takes the search."""
    from mvpnet_torch.ops import knn_bucketed

    d = cfg.data
    refs = d.num_views_train * d.image_height * d.image_width
    if not knn_bucketed.supported(d.num_points, refs):
        return None
    return knn_bucketed.route(rows, d.num_points, refs)


def step_launches(cfg: Config, device: torch.device) -> dict:
    """The launches one training step of ``cfg`` must give on ``device``:
    ``grad_accum`` microbatches of ``expected_launches`` on the card, none on
    the CPU (the plain versions)."""
    if device.type != "cuda":
        return dict.fromkeys(ops.KERNELS, 0)
    from mvpnet_torch.ops import fps

    accum = max(1, int(cfg.train.grad_accum))
    return {k: n * accum for k, n in expected_launches(cfg, fps.shared_bytes(device)).items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device: torch.device) -> dict:
    """JAX's ``hbm`` keys from the caching allocator (None on the CPU)."""
    if device.type != "cuda":
        return {"bytes_in_use": None, "peak_bytes_in_use": None}
    return {"bytes_in_use": torch.cuda.memory_allocated(device),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(device)}


def _reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def _check(what: str, counts: dict, want: dict, loss: float) -> None:
    if counts != want:
        raise RuntimeError(f"{what}: kernel launches {counts}, expected {want}")
    if not np.isfinite(loss):
        raise RuntimeError(f"{what}: loss {loss}")


def timed_step(step, device: torch.device) -> tuple[float, float, dict]:
    """(seconds, loss, launches) of ``step()``, the launch counts set to 0
    just before it; ends in a synchronize."""
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    loss = float(step()["loss"])
    _sync(device)
    return time.perf_counter() - t0, loss, ops.launch_counts()


def train_variant(cfg: Config, batch: dict, device: torch.device, steps: int, label: str) -> dict:
    """One step, then ``steps`` timed steps of ``make_train_step`` on
    ``batch`` from seeded weights; each step's launches asserted."""
    from mvpnet_torch.models.build import build_model
    from mvpnet_torch.train.checkpoint import trainable_parameters
    from mvpnet_torch.train.loop import set_train_mode
    from mvpnet_torch.train.solver import build_optimizer
    from mvpnet_torch.train.step import make_train_step

    _reset_peak(device)
    model, loss_fn, metric_fn = build_model(cfg, seed=0)
    model = model.to(device)
    set_train_mode(model, cfg)
    optimizer = build_optimizer(cfg.solver, trainable_parameters(model, cfg.model.freeze_2d))
    train_step = make_train_step(cfg, loss_fn, metric_fn)
    generator = torch.Generator().manual_seed(0)
    want = step_launches(cfg, device)
    times, losses = [], []
    for i in range(1 + steps):
        seconds, loss, counts = timed_step(lambda: train_step(model, optimizer, batch, generator), device)
        _check(f"{label} step {i}", counts, want, loss)
        times.append(seconds)
        losses.append(loss)
    step_ms = statistics.median(times[1:]) * 1e3
    B = cfg.train.batch_size
    out = {
        "step_ms": step_ms,
        "step_ms_all": [t * 1e3 for t in times[1:]],
        "chunks_per_sec": B / (step_ms / 1e3),
        "first_step_s": times[0],
        "loss": losses[-1],
        "losses": losses,
        "hbm": _peak(device),
        "launches_per_step": counts,
    }
    print(f"  {label}: step {step_ms:.2f} ms median of {steps} (first {times[0]:.2f} s), "
          f"{out['chunks_per_sec']:.2f} chunks/s, loss {losses[-1]:.4f}, peak {out['hbm']['peak_bytes_in_use']} B, "
          f"launches {counts}", flush=True)
    del model, optimizer
    return out


def entry_steps(cfg: Config, device: torch.device, steps: int) -> tuple[dict, dict]:
    """``steps`` steps of ``entry.train_entry`` at ``cfg`` on synthetic
    scenes after one warm-up step: the wait for each batch apart from the
    step; launches asserted. Returns (summary, the first
    batch)."""
    from mvpnet_torch.entry import train_entry

    _reset_peak(device)
    step, (_, _, batches) = train_entry(device=device, cfg=cfg, seed=0)
    want = step_launches(cfg, device)
    waits, times, losses, first = [], [], [], None
    try:
        for i in range(1 + steps):
            t0 = time.perf_counter()
            batch = next(batches)
            wait = time.perf_counter() - t0
            first = batch if first is None else first
            seconds, loss, counts = timed_step(lambda: step(batch), device)
            _check(f"train_entry step {i}", counts, want, loss)
            waits.append(wait * 1e3)
            times.append(seconds * 1e3)
            losses.append(loss)
    finally:
        batches.close()
    per_step = statistics.median(times[1:]) + statistics.median(waits[1:])
    out = {
        "steps": steps, "step_ms": times[1:], "data_wait_ms": waits[1:], "first_step_ms": times[0],
        "chunks_per_sec": cfg.train.batch_size / (per_step / 1e3), "loss": losses[-1], "hbm": _peak(device),
        "launches_per_step": counts,
    }
    print(f"  train_entry: step {statistics.median(times[1:]):.2f} ms median, data wait "
          f"{statistics.median(waits[1:]):.2f} ms, {out['chunks_per_sec']:.2f} chunks/s", flush=True)
    return out, first


def train_shape(cfg: Config, device: torch.device, steps: int, label: str) -> dict:
    """``base`` and ``remat`` on ``cfg``'s numpy batch (``example_batch``,
    seed 0, the training views)."""
    d = cfg.data
    B, N, V, H, W = cfg.train.batch_size, d.num_points, d.num_views_train, d.image_height, d.image_width
    print(f"{label}: B{B} N{N} V{V} grad_accum={cfg.train.grad_accum}", flush=True)
    batch = to_device(example_batch(np.random.default_rng(0), B=B, N=N, V=V, H=H, W=W, num_classes=d.num_classes),
                      device)
    res = {
        "shape": {"B": B, "N": N, "V": V, "H": H, "W": W},
        "grad_accum": cfg.train.grad_accum,
        "pixel_refs": V * H * W,
        "fusion_mode": fusion_mode(cfg, B // max(1, cfg.train.grad_accum)),
    }
    for variant, remat in (("base", False), ("remat", True)):
        vcfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, remat=remat))
        res[variant] = train_variant(vcfg, batch, device, steps, f"{label} {variant}")
        _sync(device)
    res["donate"] = DONATE
    return res


def config3(opts, device: torch.device) -> dict:
    cfg = load_config(CONFIG3, SYNTHETIC + list(opts))
    res = train_shape(cfg, device, STEPS, "config #3")
    res["note"] = ("grad_accum=4 runs the batch of 32 as 4 x B8 microbatches, eager, one optimizer update a "
                   "step; the peak is torch.cuda.max_memory_allocated over the variant's steps")
    if device.type == "cuda":
        from mvpnet_torch.ops import fps

        rows = cfg.train.batch_size // max(1, cfg.train.grad_accum)
        clusters = fps.cluster_occupancy(cfg.data.num_points, device)
        res["fps_perrow_clusters"] = {"rows": rows, "row_points": cfg.data.num_points,
                                      "max_active_clusters": clusters, "waves": -(-rows // max(clusters, 1))}
        print(f"  fps_perrow: {clusters} clusters at once for {rows} rows of {cfg.data.num_points} points",
              flush=True)
    res["train_entry"] = entry_steps(cfg, device, ENTRY_STEPS)[0]
    return res


def config4_train(opts, device: torch.device) -> dict:
    cfg = load_config(CONFIG4, SYNTHETIC + list(opts))
    return train_shape(cfg, device, STEPS, "config #4 train")


def config4(opts, device: torch.device) -> dict:
    """The fused whole-scene estimator at config #4 and its stages apart
    (``tools/config_shapes_bench.py:108-196``)."""
    from mvpnet_torch.data.synthetic import make_scene
    from mvpnet_torch.eval.scene_fused import build_scene_fused_fns, predict_scene_fused
    from mvpnet_torch.eval.sharded_scene import enumerate_scene_chunks, select_scene_views
    from mvpnet_torch.models.build import build_model

    points, frames = SCENE_POINTS, SCENE_FRAMES
    cfg = load_config(CONFIG4, SYNTHETIC + list(opts) + [f"eval.scene_views={frames}", "eval.batch_size=1"])
    print(f"config #4: building a {frames}-frame scene of {points} points", flush=True)
    d = cfg.data
    scene = make_scene(0, num_points=points, num_frames=frames, height=d.image_height, width=d.image_width,
                       num_classes=d.num_classes)
    _reset_peak(device)
    model, _, _ = build_model(cfg, seed=0)
    model = model.to(device).eval()
    fns = build_scene_fused_fns(model, cfg)

    def scene_s():
        t0 = time.perf_counter()
        logits = predict_scene_fused(model, cfg, scene, fns=fns, chunk_group=1)
        _sync(device)
        return time.perf_counter() - t0, logits

    warm_s, _ = scene_s()
    ops.reset_launch_counts()
    timed_s, logits = scene_s()
    launches = ops.launch_counts()
    if not np.isfinite(logits).all():
        raise RuntimeError("config #4: non-finite scene logits")

    pixel_fn, prepare_fn, fuse_fn = fns
    frames_sel = select_scene_views(scene, frames)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    args = (put(scene.rgb[frames_sel]), put(scene.depth[frames_sel]), put(scene.poses[frames_sel]),
            put(scene.intrinsics))
    with torch.no_grad():
        _sync(device)
        t0 = time.perf_counter()
        pixel_xyz, pixel_feat = pixel_fn(*args)
        _sync(device)
        pixel_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        prepared = prepare_fn(pixel_xyz)
        _sync(device)
        prep_s = time.perf_counter() - t0
        chunks = enumerate_scene_chunks(scene, cfg)
        pts = put(np.stack([chunks[0][1]]))
        fuse_fn(pts, prepared, pixel_xyz, pixel_feat)  # warm
        _sync(device)
        t0 = time.perf_counter()
        fuse_fn(pts, prepared, pixel_xyz, pixel_feat)
        _sync(device)
        fuse_s = time.perf_counter() - t0
    out = {
        "scene": {"points": len(scene.points), "views": int(len(frames_sel)), "pixels": int(pixel_xyz.shape[1]),
                  "chunk_points": d.num_points, "n_chunks": len(chunks)},
        "scene_eval_s": timed_s,
        "scene_eval_warm_s": warm_s,
        "pixel_stage_ms": pixel_s * 1e3,
        "knn_prepare_ms": prep_s * 1e3,
        "fuse_per_chunk_ms": fuse_s * 1e3,
        "hbm": _peak(device),
        "logits_shape": list(logits.shape),
        "launches_per_scene": launches,
    }
    print(f"  config4: {json.dumps(out)}", flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--only", default=None, choices=["3", "4"])
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--name", default="config_shapes")
    ap.add_argument("--out-dir", default=os.path.join("runs", "torch_config_shapes"))
    ap.add_argument("opts", nargs="*", help="key=value overrides of every config")
    args = ap.parse_intermixed_args(argv)
    device = resolve_device(args.device)
    out = {"card": card_line(device), "torch": torch.__version__, "overrides": args.opts}
    if args.only in (None, "3"):
        out["config3"] = config3(args.opts, device)
    if args.only in (None, "4"):
        out["config4_train"] = config4_train(args.opts, device)
        out["config4"] = config4(args.opts, device)
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, f"{args.name}.json"), "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
