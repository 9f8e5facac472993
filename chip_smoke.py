#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (mvpnet_torch) on one GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each of which fails the run with a nonzero exit:
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. build every CUDA kernel from mvpnet_torch/csrc (one nvcc per source, all
     at once) and print the build seconds;
  3. kernels: at the shapes the main path gives them, plus masked/sentinel,
     duplicate-point and two-row cases (and FPS rows too long for shared
     memory), each kernel must equal its plain PyTorch version on the card
     (indices and counts equal, distances bit for bit); the fusion kNN (row
     1) in both its modes, demand-gated and brute, on every query, also with
     masked refs and rows with fewer than k real refs (ties to the lower
     index); the block layouts of FPS (rows of 1 to the longest the block
     kernel takes, npoint = N and > N, invalid rows, a batch of 8), of the
     ball query (blocks cut short, tile tails, all balls empty or full in
     the first tile, K of 1 and 64) and of the three-NN (row 4 at every
     lanes a query and queries a thread: ties, masked refs, k of 1, 3 and 8,
     fewer refs than lanes x k, tails of tiles and of lane groups, both tile
     copies); each kernel is timed with CUDA events beside its plain
     version, a PyTorch yardstick where one exists (for the kNN kernels,
     rows 1, 4, 6 and 7, torch.cdist then topk over the same queries; a
     single call above YARDSTICK_ONCE_PAIRS pairs), and
     its bound, the larger of its instructions over the instruction floor
     and its bytes over HBM bandwidth (row 1's from the pairs its route's
     mode scanned, the all-pairs bound beside it); rows 2-4 at their first
     launch of the forward, then at every launch (SA1-SA4, FP1-FP4), each
     held and timed, under "levels" with their sum;
  4. slice: entry() at the default Config() (full width, bf16, B=1, N=8192,
     V=5 views of 120x160) answers 5 requests, each on a fresh numpy-seeded
     batch; every request must launch each kernel the expected number of
     times and return finite (1, 8192, 20) logits; one request is answered
     again with set_impl("reference") and must give the same index outputs
     and argmaxes; one request in the compact wire format (uint8 / uint16 /
     int16) must answer as its dequantized float32 twin;
  5. scene: scene_entry() at the high-resolution config (BASELINE.json
     config #4: 102,400-point chunks of 6 m, stride 3 m, 64 views of
     120x160, 4 windows a forward; full width, random weights from seed 0)
     over a numpy-seeded synthetic scene of 300,000 points and 96 frames,
     which has exactly 4 occupied windows, so one forward of B=4:
       (a) evaluate_scenes through the kernels: the forward must launch each
           kernel the expected number of times (fps_perrow once, at SA1),
           the device accumulator must be finite and cover most points;
           prints the scene's seconds, the ms of the forward and the mIoU;
       (b) each kernel against its plain version on this path's inputs: the
           per-row FPS (the cluster kernel) at the full SA1 shape, masked,
           with npoint > N, and on one 2^19-point row whose slices overflow
           into device memory; rows 2-4 at every level (the block FPS from
           SA2); the fusion kNN at full shape in both modes, held
           on the first 256 queries of each row of the full run (its plain
           version cannot run the full shape); each timed at the full shape,
           beside the cdist + topk yardstick on the same queries;
       (c) predict_scene through the kernels and with set_impl("reference")
           at the config's widths with data.num_points=16384 and
           data.num_views_eval=8 (SA1 rows of 16,384 points still take the
           per-row FPS): equal index-op outputs, argmax agreement > 0.999;
       (d) the fused estimator (evaluate_scenes(..., fused=True)): finite
           logits; and knn_prepared over the scene's prepared pixel cloud
           (ops.knn_prepare) with the first group of windows as queries: equal
           to knn in full and to the plain version on its first 256 queries;
       (e) the fusion kNN in both modes at five shapes of the scene's
           windows between the train shape and the fused estimator's
           (CROSSOVER): held like (b), each mode timed, the route's mode
           printed beside the faster one.
  6. train: train_entry() at the training config
     (configs/scannet/mvpnet_3d_unet_resnet34_pn2ssg.yaml on synthetic scenes:
     full width, bf16, B=8, N=8192, V=3 views of 120x160, random weights from
     seed 0):
       (a) 10 steps with grad_accum=1, then 10 with grad_accum=2: every step
           must launch each kernel the expected number of times (per
           microbatch) and give a finite loss; BN statistics and parameters
           must move; a checkpoint save / disturb / restore must give the
           model and optimizer back exactly; prints ms per step, chunks/s and
           the peak memory;
       (b) the gated kernels (rows 6 and 7) against their plain versions on
           the first batch's fusion inputs (sentinel pixels included) at the
           full shape, compared on the first 256 queries of each row, and
           with masked refs, duplicate points, a batch of 2 and the refs in
           their order (refs_coherent), each at lanes 1 to 32 a query row and
           at the layout rule's; their prep (morton.prepare_device, the
           kernels of csrc/morton.cu) against its plain version, every
           output, at both rows' tiles and with the refs in their order, and
           its device launches a call (at most PREP_MAX_LAUNCHES, from
           torch.profiler) beside the plain chain's; each timed beside the
           default fusion kernel (both modes) at that shape, and FPS, ball
           query and three-NN (rows 2-4) at every level of the step's
           forward; row 6's tiles of 8192 refs are also checked and timed
           at the scene path's fusion shape in 5 (b). The bound of a gated
           search (rows 6, 7 and row 1's demand mode) counts the pairs its
           inputs need (need_pairs), the pairs its gates let through beside
           it;
       (c) the first step again from the same weights and batch with the
           fusion kNN on each variant (demand, gated, resident): each
           launches its kernel once (and the gated ones their prep once),
           with equal fusion indices and loss.
  7. recipe: the paper's recipe through the entry points a user calls, at
     full width on synthetic scenes (ScanNet is not in the repository):
       (a) the 2D path: train_entry() at
           configs/scannet/sem_seg_2d_unet_resnet34.yaml with
           data.sampling=frames (UNet-ResNet34, bf16, B=32 frames of
           120x160): 10 steps, each with a finite loss and no kernel launch;
           BN statistics and parameters must move; ms per step, peak memory;
       (b) the PointNet++ baselines: train_entry() at
           configs/scannet/pn2ssg_xyz.yaml and pn2ssg_rgb.yaml (B=8,
           N=8192; colors in the rgb batches only): 10 steps each, each
           launching FPS, ball query and three-NN 4 times and the fusion kNN
           never; the first step again from the same weights and batch
           through the kernels and with set_impl("reference"): equal
           index-op outputs and loss;
       (c) the command lines, in outputs/chip_smoke_recipe (removed after):
           cli.train_2d writes a checkpoint; cli.train_3d at the training
           config with model.pretrained_2d there holds the 2D checkpoint's
           net_2d before its first step, then trains a few steps;
           cli.test_3d --export on that run prints a finite mIoU in [0, 1]
           and writes one NYU40 file a validation scene, each forward
           launching the chunk path's kernels; cli.test_3d on a pn2ssg_rgb
           run (colors in every forward's batch, no fusion kNN); cli.test_2d
           on the 2D run prints its results.
     It prints the {"recipe": ...} line and its seconds.
Then it prints the {"kernels": [...]} line (seven kernels and the prep of
rows 6 and 7, "morton_prep": their launches, each row's launches on the
recipe's paths under "recipe_launches",
times and bounds on the scene path, the chunk path's under "chunk_path",
the train path's under "train_path", knn_prepared's under "fused_path";
rows 6 and 7 at the train shape, row 6's subgroup gate under "scene_path"),
the card line, and last
{"ok": true, "device": {...}}.
Without CUDA, or without the mvpnet_torch package beside it, it exits
nonzero and prints no result.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

# the instruction floor of one H100 SXM at its full 700 W outside the tensor
# cores: 132 SMs x 128 FP32 lanes x 1.98 GHz = 33.5e12 lane-instructions a
# second (NVIDIA's 67 TFLOP/s counts an FMA as two operations). The kernels
# build with -fmad=false, so each operation they count (a subtraction, a
# product, a sum, a compare) is one instruction of its own; and HBM3 bandwidth
INSTR_PER_S = 33.5e12
HBM_BYTES_PER_S = 3.35e12
# elements of one (queries, refs) distance block of the cdist + topk yardstick;
# above YARDSTICK_ONCE_PAIRS (query, ref) pairs one call of it takes seconds,
# and it is timed once, with no warm-up
YARDSTICK_ELEMS = 1 << 30
YARDSTICK_ONCE_PAIRS = 1 << 36
KERNEL_REPS = 30
PLAIN_REPS = 5
# per request: fusion kNN once, FPS / ball query / three-NN once per level
EXPECTED_LAUNCHES = {
    "knn_fusion": 1, "fps": 4, "fps_perrow": 0, "ball_query": 4, "knn": 4, "knn_gated": 0, "knn_resident": 0,
    "morton_prep": 0,
}
# per scene forward at config #4: SA1's 102,400-point rows are too long for
# shared memory and take the per-row FPS; SA2-SA4 the shared-memory one
SCENE_LAUNCHES = dict(EXPECTED_LAUNCHES, fps=3, fps_perrow=1)
# per train step (per microbatch with grad_accum): the chunk path's forward;
# the backward launches no kernel
TRAIN_LAUNCHES = EXPECTED_LAUNCHES
TRAIN_STEPS = 10
# the recipe phase: per 2D pretraining step (the UNet alone) no kernel; per
# PointNet++ baseline step or forward FPS / ball query / three-NN once per
# level and no fusion kNN
RECIPE_2D_LAUNCHES = dict.fromkeys(EXPECTED_LAUNCHES, 0)
BASELINE_LAUNCHES = dict(EXPECTED_LAUNCHES, knn_fusion=0)
CONFIG_2D = "configs/scannet/sem_seg_2d_unet_resnet34.yaml"
BASELINE_CONFIGS = {"pn2ssg_xyz": "configs/scannet/pn2ssg_xyz.yaml", "pn2ssg_rgb": "configs/scannet/pn2ssg_rgb.yaml"}
# ScanNet is not in the repository: every recipe run is on synthetic scenes
SYNTHETIC = ["data.name=synthetic"]
CLI_STEPS = 3
# the fusion kNN's kernel for each ops.set_fusion_variant
VARIANT_KERNEL = {"demand": "knn_fusion", "gated": "knn_gated", "resident": "knn_resident"}
TPU_KERNELS = {
    "knn_fusion": ("mvpnet_torch/csrc/knn_fusion.cu", "mvpnet_tpu/ops/pallas/knn_bucketed.py:238"),
    "fps": ("mvpnet_torch/csrc/fps.cu", "mvpnet_tpu/ops/pallas/fps.py:83"),
    "ball_query": ("mvpnet_torch/csrc/ballquery.cu", "mvpnet_tpu/ops/pallas/ballquery.py:39"),
    "knn": ("mvpnet_torch/csrc/knn.cu", "mvpnet_tpu/ops/pallas/knn.py:76"),
    "fps_perrow": ("mvpnet_torch/csrc/fps.cu", "mvpnet_tpu/ops/pallas/fps.py:44"),
    "knn_gated": ("mvpnet_torch/csrc/knn_gated.cu", "mvpnet_tpu/ops/pallas/knn_bucketed.py:142"),
    "knn_resident": ("mvpnet_torch/csrc/knn_resident.cu", "mvpnet_tpu/ops/pallas/knn_bucketed.py:401"),
    # the prep of rows 6 and 7 replaces jnp code outside any Pallas kernel
    # (_prepare, :693; _unmap, :610)
    "morton_prep": ("mvpnet_torch/csrc/morton.cu", "mvpnet_tpu/ops/pallas/knn_bucketed.py:693"),
}
# the gated kernels' prep (morton.prepare_device): device launches a call at
# most (csrc/morton.cu's eight)
PREP_MAX_LAUNCHES = 10
SCENE_SEED = 0
SCENE_SHAPE = dict(num_points=300_000, num_frames=96, room=6.0)
# (c): the scene path at reduced depth, where the plain versions run in time
REDUCED = ["data.num_points=16384", "data.num_views_eval=8"]
FUSION_SUBSET = 256  # queries of each row for the fusion kNN's plain version
# (e): config #4's windows at fewer points and views (data.num_points,
# data.num_views_eval), searches of 5.0e9 to 6.3e10 (query, ref) pairs:
# between the train shape (3.8e9, where row 1's brute mode is faster) and the
# fused estimator's (9.4e10, where its demand mode is), around
# knn_bucketed.DEMAND_PAIRS; (16384, 8) is (c)'s reduced depth
CROSSOVER = [(8192, 8), (16384, 8), (32768, 5), (32768, 16), (102400, 8)]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(ops: float, nbytes: float) -> tuple[float, str]:
    """The least time of ``ops`` instructions and ``nbytes`` moved: the
    instruction floor or the bytes over HBM bandwidth, the larger."""
    t_ops, t_bytes = ops / INSTR_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def need_pairs(torch, queries, kth, boxes, tile_n: int, rows_a_step: int = 4096) -> tuple[int, float]:
    """(pairs, tiles a row) that a tiled exact search of ``queries`` (B, M,
    3) needs, given each row's final k-th distance ``kth`` (B, M): for each
    row, the tiles whose bound to the row's point is below its k-th
    distance, at least one (the first tile is always read), each tile of
    ``tile_n`` refs. ``boxes``: (lo, hi) pairs, each (B, Nt, 3); a tile's
    bound is the least squared distance from the point to any of its boxes
    (an empty box, (+inf, -inf), bounds nothing). The bound of the gated
    searches (rows 1 in its demand mode, 6 and 7) counts these pairs: what
    the inputs need, whatever the kernel's gates let through."""
    B, M, _ = queries.shape
    tiles = 0
    for s in range(0, M, rows_a_step):
        q = queries[:, s : s + rows_a_step, None, :].float()  # (B, m, 1, 3)
        lb = None
        for lo, hi in boxes:
            gap = torch.clamp(torch.maximum(lo[:, None] - q, q - hi[:, None]), min=0.0)
            d = (gap * gap).sum(-1)  # (B, m, Nt)
            lb = d if lb is None else torch.minimum(lb, d)
        tiles += int((lb < kth[:, s : s + rows_a_step, None]).sum(-1).clamp(min=1).sum())
    return tiles * tile_n, tiles / (B * M)


def cdist_topk(torch, q, r, k: int):
    """The same-function yardstick of the kNN kernels: torch.cdist, then
    topk(k, largest=False), over every query, in blocks of queries where the
    whole (M, N) distance matrix would not fit. The port never calls it."""
    B, M, N = q.shape[0], q.shape[1], r.shape[1]
    step = max(1, YARDSTICK_ELEMS // (B * N))
    out = [torch.cdist(q[:, s : s + step], r).topk(k, dim=-1, largest=False) for s in range(0, M, step)]
    return torch.cat([o.values for o in out], 1), torch.cat([o.indices for o in out], 1)


def same(torch, name: str, got, want) -> float:
    """Require bit-equal outputs; returns the max abs error (0.0)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
            bad = (g != w).sum().item() if g.shape == w.shape else "shape"
            fail(f"{name}: kernel differs from its plain version ({bad} elements)")
        if g.is_floating_point():
            err = max(err, (g - w).abs().max().item())
    return err


def kernel_phase(torch, cfg, batch) -> list[dict]:
    from mvpnet_torch.models.pointnet2 import gather_points
    from mvpnet_torch.ops import KERNELS, reference

    fusion, fps, bq, brute = (KERNELS[k] for k in ("knn_fusion", "fps", "ball_query", "knn"))
    sa1 = cfg.model.pn2.sa[0]
    k = cfg.model.aggregation.k
    pts = batch["points"].float().contiguous()  # (1, 8192, 3)
    pix = batch["image_xyz"].reshape(pts.shape[0], -1, 3).contiguous()  # (1, 96000, 3)
    g = torch.Generator(device=pts.device).manual_seed(0)

    def rnd(*shape):  # uniform in [-2, 2), like the example batch's points
        return torch.rand(shape, generator=g, device=pts.device) * 4 - 2

    # main-path shapes: SA1 FPS, its centers, SA1 ball query, FP4 three-NN
    idx1 = fps.farthest_point_sample(pts, sa1.npoint)
    same(torch, "fps SA1", idx1, reference.farthest_point_sample(pts, sa1.npoint))
    c1 = gather_points(pts, idx1)
    idx2 = fps.farthest_point_sample(c1, cfg.model.pn2.sa[1].npoint)
    same(torch, "fps SA2", idx2, reference.farthest_point_sample(c1, cfg.model.pn2.sa[1].npoint))

    # masked / sentinel and duplicate-point inputs
    pix_sentinel = pix.clone()
    pix_sentinel[torch.rand(pix.shape[:2], generator=g, device=pix.device) < 0.2] = 1e6
    pix_dup = pix.clone()
    half = pix.shape[1] // 2
    pix_dup[:, half : 2 * half] = pix[:, :half]
    pts_dup = torch.cat([pts[:, : pts.shape[1] // 2]] * 2, dim=1)
    valid = torch.rand(pts.shape[:2], generator=g, device=pts.device) > 0.1
    valid[:, 0] = False  # the seed must move to the first valid point
    pix_batch = torch.cat([pix, pix_sentinel])  # two batch rows
    pts_batch = torch.cat([pts, pts_dup])
    # rows too long for shared memory: fps.cu's cluster kernel
    long_rows = rnd(2, 20000, 3)
    checks = [
        ("fps long rows, batch of 2", lambda: fps.farthest_point_sample(long_rows, 256), lambda: reference.farthest_point_sample(long_rows, 256)),
        ("fps masked", lambda: fps.farthest_point_sample(pts, sa1.npoint, valid), lambda: reference.farthest_point_sample(pts, sa1.npoint, valid)),
        ("fps duplicates", lambda: fps.farthest_point_sample(pts_dup, sa1.npoint), lambda: reference.farthest_point_sample(pts_dup, sa1.npoint)),
        ("ball_query masked", lambda: bq.ball_query(c1, pts, sa1.radius, sa1.nsample, valid), lambda: reference.ball_query(c1, pts, sa1.radius, sa1.nsample, valid)),
        ("ball_query duplicates", lambda: bq.ball_query(c1, pts_dup, sa1.radius, sa1.nsample), lambda: reference.ball_query(c1, pts_dup, sa1.radius, sa1.nsample)),
        ("ball_query empty balls", lambda: bq.ball_query(c1 + 50.0, pts, sa1.radius, sa1.nsample), lambda: reference.ball_query(c1 + 50.0, pts, sa1.radius, sa1.nsample)),
        ("knn masked refs", lambda: brute.knn(pts, reference.mask_points(c1, valid[:, : c1.shape[1]]), 3), lambda: reference.knn(pts, reference.mask_points(c1, valid[:, : c1.shape[1]]), 3)),
        ("knn duplicates", lambda: brute.knn(pts, torch.cat([c1, c1], 1), 3), lambda: reference.knn(pts, torch.cat([c1, c1], 1), 3)),
    ]
    # the fusion kNN in both modes (the route takes brute at this shape) on
    # every query: sentinel pixels, exact duplicates (ties to the lower
    # index), masked refs, and rows with fewer than k real refs (the rest tie
    # at the 1e6 fill and the 1e9 mask sentinel)
    pix_masked = reference.mask_points(pix, torch.rand(pix.shape[:2], generator=g, device=pix.device) > 0.3)
    pix_few = torch.full_like(pix, 1e6)
    pix_few[:, 1::7] = reference.MASK_COORD
    pix_few[:, [5, pix.shape[1] - 3]] = pix[:, [5, pix.shape[1] - 3]]
    for mode in fusion.MODES:
        for label, q, r in [("batch of 2", pts_batch, pix_batch), ("sentinel", pts, pix_sentinel),
                            ("duplicates", pts, pix_dup), ("masked refs", pts, pix_masked),
                            ("fewer than k real refs", pts, pix_few)]:
            checks.append((f"knn_fusion {mode} {label}", lambda q=q, r=r, mode=mode: fusion.knn(q, r, k, mode=mode),
                           lambda q=q, r=r: reference.knn(q, r, k)))
    # ragged edges: tails of tiles, slices and warps; k = N; K > 32; npoint > N
    q37, r5, r2049, q300, r33k, p33, p5, p100 = (
        rnd(2, 37, 3), rnd(2, 5, 3), rnd(1, 2049, 3), rnd(2, 300, 3), rnd(2, 33000, 3), rnd(3, 33, 3), rnd(1, 5, 3), rnd(2, 100, 3)
    )
    checks += [
        ("knn edges k=N", lambda: brute.knn(q37, r5, 5), lambda: reference.knn(q37, r5, 5)),
        ("knn edges tile tail k=8", lambda: brute.knn(q37[:1], r2049, 8), lambda: reference.knn(q37[:1], r2049, 8)),
        ("knn_fusion demand edges k=8", lambda: fusion.knn(q300, r33k, 8, mode="demand"), lambda: reference.knn(q300, r33k, 8)),
        ("knn_fusion brute edges k=8", lambda: fusion.knn(q300, r33k, 8, mode="brute"), lambda: reference.knn(q300, r33k, 8)),
        ("fps edges npoint=N", lambda: fps.farthest_point_sample(p33, 33), lambda: reference.farthest_point_sample(p33, 33)),
        ("fps edges npoint>N", lambda: fps.farthest_point_sample(p5, 8), lambda: reference.farthest_point_sample(p5, 8)),
        ("ball_query edges K=N", lambda: bq.ball_query(q37, p100[:, :40], 1.5, 40), lambda: reference.ball_query(q37, p100[:, :40], 1.5, 40)),
        ("ball_query edges K=64", lambda: bq.ball_query(q37, p100, 2.0, 64), lambda: reference.ball_query(q37, p100, 2.0, 64)),
    ]
    checks += layout_edge_checks(torch, cfg, pts, rnd)
    for name, kern, plain in checks:
        same(torch, name, kern(), plain())
        print(f"  {name}: equal", flush=True)

    shape = f"{pts.shape[0]}x{pts.shape[1]} queries over {pix.shape[1]} refs, k={k}"
    return [measure(torch, fusion_case(torch, pts, pix, k, shape))] + list(path_rows(torch, cfg, pts).values())


def layout_edge_checks(torch, cfg, pts, rnd) -> list:
    """(name, kernel, plain) checks of the block layouts of rows 2 and 3:
    FPS rows of every register layout up to the longest row ``route`` sends
    to the shared-memory kernel, with npoint = N and npoint > N, an
    all-invalid row, masked leading points and a batch of 8; ball queries
    whose blocks' centers end short of a whole block, points that end short
    of a tile, balls all empty or all full in the first tile, K of 1 and 64."""
    from mvpnet_torch.models.pointnet2 import gather_points
    from mvpnet_torch.ops import KERNELS, reference

    fps, bq = KERNELS["fps"], KERNELS["ball_query"]
    sa1 = cfg.model.pn2.sa[0]
    longest = fps.shared_bytes(pts.device) // fps.ROW_BYTES
    checks = []
    for n in (1, 31, 33, 100, 250, 1023, 1025, 8191, 8192, longest):
        row = rnd(1, n, 3)
        for npoint in (n, n + 3):
            checks.append((f"fps layout N={n} npoint={npoint} ({fps.block_layout(n)})",
                           lambda row=row, npoint=npoint: fps.farthest_point_sample(row, npoint),
                           lambda row=row, npoint=npoint: reference.farthest_point_sample(row, npoint)))
    rows8 = torch.cat([pts] * 8) + rnd(8, 1, 3)
    valid = torch.zeros((2, 1025), dtype=torch.bool, device=pts.device)  # row 0: no valid point
    valid[1, 700:] = True  # row 1: its first 700 points masked
    two = rnd(2, 1025, 3)
    checks += [
        ("fps all-invalid row and masked leading points", lambda: fps.farthest_point_sample(two, 300, valid),
         lambda: reference.farthest_point_sample(two, 300, valid)),
        ("fps batch of 8", lambda: fps.farthest_point_sample(rows8, sa1.npoint),
         lambda: reference.farthest_point_sample(rows8, sa1.npoint)),
    ]
    c1 = gather_points(pts, fps.farthest_point_sample(pts, sa1.npoint))
    M = 1000  # not a multiple of the block's centers at B=1
    per_block = bq.centers_per_block(1, M, torch.cuda.get_device_properties(pts.device).multi_processor_count)
    short = pts[:, : 5 * bq.TILE - 7].contiguous()  # ends inside a tile
    mixed = c1.clone()
    mixed[:, 1::2] += 50.0  # every other center far away: full balls beside empty ones in each block
    checks += [
        (f"ball_query B=1, {M} centers, {per_block} a block", lambda: bq.ball_query(c1[:, :M], pts, sa1.radius, sa1.nsample),
         lambda: reference.ball_query(c1[:, :M], pts, sa1.radius, sa1.nsample)),
        (f"ball_query {short.shape[1]} points (tile tail)", lambda: bq.ball_query(c1, short, 0.3, 64),
         lambda: reference.ball_query(c1, short, 0.3, 64)),
        ("ball_query all balls empty", lambda: bq.ball_query(c1[:, :M] + 50.0, short, sa1.radius, 1),
         lambda: reference.ball_query(c1[:, :M] + 50.0, short, sa1.radius, 1)),
        ("ball_query all balls full in the first tile K=64", lambda: bq.ball_query(c1, pts, 100.0, 64),
         lambda: reference.ball_query(c1, pts, 100.0, 64)),
        ("ball_query K=1", lambda: bq.ball_query(c1, pts, sa1.radius, 1),
         lambda: reference.ball_query(c1, pts, sa1.radius, 1)),
        ("ball_query full balls beside empty ones", lambda: bq.ball_query(mixed, pts, 1.0, 32),
         lambda: reference.ball_query(mixed, pts, 1.0, 32)),
    ]
    return checks + knn_layout_checks(torch, rnd)


def knn_layout_checks(torch, rnd) -> list:
    """(name, kernel, plain) checks of row 4 at every layout its kernel
    takes, lanes a query 1 to 32 by each of QUERIES_PER_THREAD (a superset
    of what ops.knn.layout picks), each on two batch rows of: exact ties
    (every ref twice, queries on refs) at k = 3 over 300 refs in tiles of 64
    (bulk copies, a short last tile); masked refs (the 1e9 sentinel) at k = 8
    over 301 (plain loads, a padded quad); k = 1 over 2052 refs in tiles of
    1024 (a last tile of 4) with 1000 queries; 9 refs at k = 8 (fewer than
    lanes x k); and k = 3 over 2049 refs (a plain-load tile tail). The query
    counts (37, 1000) end inside a block's lane groups."""
    from mvpnet_torch.ops import KERNELS, reference

    brute = KERNELS["knn"]
    r150 = rnd(2, 150, 3)
    ties_q = rnd(2, 37, 3)
    ties_q[:, :10] = r150[:, :10]
    masked = rnd(2, 301, 3)
    masked[:, ::3] = reference.MASK_COORD
    cases = [  # (queries, refs, k, tile)
        (ties_q, torch.cat([r150, r150], 1), 3, 64),
        (rnd(2, 37, 3), masked, 8, 64),
        (rnd(2, 1000, 3), rnd(2, 2052, 3), 1, brute.MAX_TILE),
        (rnd(2, 37, 3), rnd(2, 9, 3), 8, 12),
        (rnd(2, 37, 3), rnd(2, 2049, 3), 3, brute.MAX_TILE),
    ]

    def run(lanes, per_thread):
        return tuple(x for q, r, k, tile in cases for x in brute.knn_at(q, r, k, lanes, per_thread, tile))

    def plain():
        return tuple(x for q, r, k, _ in cases for x in reference.knn(q, r, k))

    checks = []
    lanes = 1
    while lanes <= brute.MAX_LANES:
        for per_thread in sorted(brute.QUERIES_PER_THREAD):
            checks.append((f"knn layout lanes={lanes} queries a thread={per_thread} (ties, masked refs, k=1/3/8, "
                           f"N < lanes x k, tile tails)", functools.partial(run, lanes, per_thread), plain))
        lanes *= 2
    return checks


def level_cases(torch, cfg, pts) -> dict:
    """measure() cases of rows 2-4 at every launch of one forward's
    PointNet++ on ``pts`` (mvpnet_torch.profile_levels.levels: FPS and ball
    query at SA1-SA4, the three-NN at FP1-FP4; FPS rows too long for the
    block kernel, row 5's, are left out), with their bounds and library
    calls. Returns {kernel: [case, ...]} in level order."""
    from mvpnet_torch.ops import reference
    from mvpnet_torch.profile_levels import levels

    out = {"fps": [], "ball_query": [], "knn": []}
    for lv in levels(cfg, pts):
        if lv["kernel"] == "fps":
            xyz, npoint = lv["args"]
            B, N = xyz.shape[0], xyz.shape[1]
            ops, nbytes, library = 10.0 * B * (npoint - 1) * N, 4.0 * (3 * B * N + B * npoint), None
        elif lv["kernel"] == "ball_query":
            new, xyz, radius, nsample = lv["args"]
            B, M, N = new.shape[0], new.shape[1], xyz.shape[1]
            idx, cnt = reference.ball_query(new, xyz, radius, nsample)
            # pairs the search needs: each center up to its K-th hit, else every point
            pairs = torch.where(cnt == nsample, idx[..., -1].long() + 1, N).sum().item()
            ops, nbytes = 9.0 * pairs, 4.0 * (3 * B * M + 3 * B * N + B * M * (nsample + 1))
            library = functools.partial(torch.cdist, new, xyz)
        else:
            d, s, k = lv["args"]
            B, M, Ns = d.shape[0], d.shape[1], s.shape[1]
            ops, nbytes = 9.0 * B * M * Ns, 4.0 * (3 * B * M + 3 * B * Ns + 2 * B * M * k)
            library = functools.partial(cdist_topk, torch, d, s, k)
        out[lv["kernel"]].append(dict(
            name=lv["kernel"], level=lv["level"], shape=lv["shape"], kern=lv["run"], plain=lv["plain"],
            library=library, ops=ops, nbytes=nbytes, reps=10 if ops > 1e10 else KERNEL_REPS,
        ))
    return out


def path_rows(torch, cfg, pts) -> dict:
    """Rows 2-4 on one path (its input points ``pts``): each kernel's first
    level through measure() (the row: held, timed beside its plain version,
    library call and bound), then every level held and timed, under
    ``levels``, with their sums ``sum_ms`` and ``sum_bound_ms`` (a forward's
    time in the kernel and its bound). Returns {kernel: row}."""
    rows = {}
    for name, cases in level_cases(torch, cfg, pts).items():
        first = cases[0]
        row = measure(torch, dict(first, shape=f"{first['shape']} ({first['level']})"))
        levels = []
        for i, case in enumerate(cases):
            if i == 0:
                err, ms, b_ms, b_by = row["max_abs_err"], row["ms"], row["bound_ms"], row["bound_by"]
            else:
                err = same(torch, f"{name} {case['level']}", case["kern"](), case["plain"]())
                ms = cuda_ms(torch, case["kern"], case["reps"])
                b_ms, b_by = bound_ms(case["ops"], case["nbytes"])
            levels.append(dict(level=case["level"], shape=case["shape"], ms=ms, bound_ms=b_ms, bound_by=b_by,
                               max_abs_err=err))
            print(f"  {name} {case['level']} [{case['shape']}]: equal; {ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})",
                  flush=True)
        row.update(levels=levels, sum_ms=sum(x["ms"] for x in levels),
                   sum_bound_ms=sum(x["bound_ms"] for x in levels))
        rows[name] = row
    return rows


def fusion_case(torch, q, r, k, shape, subset=None, prepared=None) -> dict:
    """measure() case of the fusion kNN (row 1) on one search, through its
    route's mode (or knn_prepared on ``prepared``, r's prepared cloud). The
    first ``subset`` queries of each row of the full run (every query when
    None) are held against the plain version in both modes, and both modes
    are timed, their preparation included. The bound counts the pairs the
    route's mode scans (the kernel counts them in the demand mode), the
    all-pairs bound beside it."""
    from mvpnet_torch import ops
    from mvpnet_torch.ops import KERNELS, reference

    fusion = KERNELS["knn_fusion"]
    B, M, N = q.shape[0], q.shape[1], r.shape[1]
    mode = "demand" if prepared is not None else fusion.route(B, M, N)
    rows = M if subset is None else subset
    reps = 3 if B * M * N > 1 << 36 else KERNEL_REPS

    def run(mode=mode, scanned=None):
        if prepared is not None:
            return fusion.knn_prepared(q, prepared, k, scanned=scanned)
        return fusion.knn(q, r, k, mode=mode, scanned=scanned)

    q_sub = q[:, :rows].contiguous()
    want = reference.knn(q_sub, r, k)
    modes = {}
    for m in (mode,) if prepared is not None else fusion.MODES:
        scanned = torch.zeros(1, dtype=torch.int64, device=q.device)
        got = run(m, scanned)
        same(torch, f"knn_fusion {m} [{shape}]", tuple(x[:, :rows] for x in got), want)
        if prepared is not None:
            same(torch, f"knn_prepared vs knn [{shape}]", got, fusion.knn(q, r, k, mode="demand"))
        pairs = scanned.item() if m == "demand" else B * M * N
        modes[m] = {"ms": cuda_ms(torch, lambda m=m: run(m), reps), "scanned_pairs": pairs,
                    "scanned_fraction": pairs / (B * M * N)}
        print(f"  knn_fusion {m}{' (knn_prepared)' if prepared is not None else ''} [{shape}]: equal on the first "
              f"{rows} queries of each row of the full run{', and to knn in full' if prepared is not None else ''}; "
              f"{modes[m]['ms']:.4f} ms, {modes[m]['scanned_fraction']:.4f} of the pairs scanned", flush=True)
    ops.reset_launch_counts()
    d_full = run()[0]
    if ops.launch_counts()["knn_fusion"] != 1:
        fail(f"knn_fusion [{shape}]: one call launched {ops.launch_counts()}")
    need, tiles_a_row = B * M * N, None
    if mode == "demand":  # the pairs these inputs need over the demand mode's tiles
        from mvpnet_torch.ops import morton

        qf = q.float()
        p = prepared if prepared is not None else morton.prepare_refs(
            r, morton.demand_tiles(M, N)[1], qf.amin(1, keepdim=True), qf.amax(1, keepdim=True))
        bx = p.boxes
        need, tiles_a_row = need_pairs(torch, q, d_full[..., k - 1], [(bx[..., 0:3], bx[..., 3:6]), (bx[..., 6:9], bx[..., 9:12])],
                                       p.tile_n)
        del p, bx
        print(f"  knn_fusion demand [{shape}]: the inputs need {need} pairs ({tiles_a_row:.3f} tiles a row), "
              f"the gates let {modes[mode]['scanned_pairs']} through", flush=True)
    return dict(
        name="knn_fusion", shape=shape, reps=reps,
        kern=run, check=lambda: tuple(x[:, :rows] for x in run()),
        plain=lambda: reference.knn(q_sub, r, k),
        plain_shape=f"{B}x{rows} queries (the first of each row) of the full search",
        library=lambda: cdist_topk(torch, q, r, k), library_once=B * M * N > YARDSTICK_ONCE_PAIRS,
        ops=9.0 * need, ops_scanned=9.0 * modes[mode]["scanned_pairs"], ops_all_pairs=9.0 * B * M * N,
        nbytes=4.0 * (3 * B * M + 3 * B * N + 2 * B * M * k),
        extra={"mode": mode, "modes": modes, "need_pairs": need, "need_tiles_a_row": tiles_a_row},
    )


def measure(torch, case: dict) -> dict:
    """Hold a kernel against its plain version and time both; the row of the
    kernels line. ``kern`` runs the kernel at the path's shape, and so does
    the library call; where the plain version cannot run that shape in time,
    ``check`` gives the kernel's outputs on the plain version's smaller
    inputs (``plain_shape``). With ``library_once`` the library call is
    timed once, with no warm-up."""
    reps = case.get("reps", KERNEL_REPS)
    check = case.get("check", case["kern"])
    err = same(torch, case["name"], check(), case["plain"]())
    ms = cuda_ms(torch, case["kern"], reps)
    plain_ms = cuda_ms(torch, case["plain"], PLAIN_REPS, warmup=1)
    if not case["library"]:
        lib_ms = None
    elif case.get("library_once"):
        lib_ms = cuda_ms(torch, case["library"], 1, warmup=0)
    else:
        lib_ms = cuda_ms(torch, case["library"], reps)
    b_ms, b_by = bound_ms(case["ops"], case["nbytes"])
    source, replaces = TPU_KERNELS[case["name"]]
    row = {
        "name": case["name"], "route": "cuda", "source": source, "replaces": replaces,
        "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms, "shape": case["shape"],
    }
    if "check" in case:
        row["plain_shape"] = case["plain_shape"]
    if "ops_all_pairs" in case:  # a gated search: the bound counts the pairs its inputs need
        row["bound_ms_all_pairs"] = bound_ms(case["ops_all_pairs"], case["nbytes"])[0]
        row["bound_ms_scanned"] = bound_ms(case["ops_scanned"], case["nbytes"])[0]
    row.update(case.get("extra", {}))
    print(f"  {case['name']} [{case['shape']}]: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain"
          f"{' [' + case['plain_shape'] + ']' if 'check' in case else ''}, "
          f"library {lib_ms}, bound {b_ms:.6f} ms ({b_by})", flush=True)
    torch.cuda.empty_cache()
    return row


@contextlib.contextmanager
def recording(ops):
    """Record the outputs of the public index ops while a request runs."""
    names = ("knn", "farthest_point_sample", "ball_query", "three_nn_interpolate")
    saved = {n: getattr(ops, n) for n in names}
    log: list = []

    def wrap(name, fn):
        def inner(*a, **kw):
            out = fn(*a, **kw)
            log.append((name, tuple(o.clone() for o in (out if isinstance(out, tuple) else (out,)))))
            return out
        return inner

    for n in names:
        setattr(ops, n, wrap(n, saved[n]))
    try:
        yield log
    finally:
        for n in names:
            setattr(ops, n, saved[n])


def compare_logs(torch, got_log, want_log, what: str) -> int:
    """Require the same ops, in the same order, with equal outputs; the count."""
    if [n for n, _ in got_log] != [n for n, _ in want_log]:
        fail(f"{what}: kernel and reference runs called different ops")
    for (name, g), (_, w) in zip(got_log, want_log):
        same(torch, f"{what} {name}", g, w)
    return len(got_log)


def slice_phase(torch, forward, model, cfg, rows) -> dict:
    from mvpnet_torch import ops
    from mvpnet_torch.entry import example_batch

    def request_batch(seed):
        return example_batch(
            np.random.default_rng(seed), B=1, N=cfg.data.num_points, V=cfg.data.num_views_eval,
            H=cfg.data.image_height, W=cfg.data.image_width, num_classes=cfg.data.num_classes,
        )

    want_shape = (1, cfg.data.num_points, cfg.data.num_classes)
    forward(model, request_batch(100))  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    totals = dict.fromkeys(EXPECTED_LAUNCHES, 0)
    request_ms = []
    for seed in range(1, 6):
        batch = request_batch(seed)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits = forward(model, batch)
        torch.cuda.synchronize()
        request_ms.append((time.perf_counter() - t0) * 1e3)
        counts = ops.launch_counts()
        if counts != EXPECTED_LAUNCHES:
            fail(f"request {seed}: kernel launches {counts}, expected {EXPECTED_LAUNCHES}")
        if tuple(logits.shape) != want_shape or not torch.isfinite(logits).all():
            fail(f"request {seed}: logits {tuple(logits.shape)}, finite={bool(torch.isfinite(logits).all())}")
        for name, n in counts.items():
            totals[name] += n
        print(f"  request {seed}: {request_ms[-1]:.3f} ms, logits {tuple(logits.shape)} finite", flush=True)
    for row in rows:  # per request (each request asserted equal), and in all
        row["launches"] = counts[row["name"]]
        row["launches_all_requests"] = totals[row["name"]]

    # the same request through the plain versions: same indices, same argmax
    batch = request_batch(1)
    with recording(ops) as got_log:
        got = forward(model, batch)
    ops.set_impl("reference")
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with recording(ops) as want_log:
            want = forward(model, batch)
        torch.cuda.synchronize()
        reference_ms = (time.perf_counter() - t0) * 1e3
        if any(ops.launch_counts().values()):
            fail(f"reference request launched kernels: {ops.launch_counts()}")
    finally:
        ops.set_impl("auto")
    n_equal = compare_logs(torch, got_log, want_log, "slice")
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    if agree <= 0.999:
        fail(f"argmax agreement with the reference path {agree}")
    print(f"  reference request: {reference_ms:.3f} ms, {n_equal} index-op outputs equal, "
          f"argmax agreement {agree}", flush=True)

    # the pipeline's compact wire format (uint8 images, uint16 mm depth, int16
    # mm points, int8 labels) must answer as its dequantized float32 twin
    raw = request_batch(2)
    compact = dict(
        raw,
        images=np.round(raw["images"] * 255).astype(np.uint8),
        depth=np.round(raw["depth"] * 1000).astype(np.uint16),
        points=np.round(raw["points"] * 1000).astype(np.int16),
        seg_label=raw["seg_label"].astype(np.int8),
        seg_label_2d=raw["seg_label_2d"].astype(np.int8),
    )
    twin = dict(
        compact,
        images=compact["images"].astype(np.float32) / 255.0,
        depth=compact["depth"].astype(np.float32) / 1000.0,
        points=compact["points"].astype(np.float32) / 1000.0,
    )
    got, want = forward(model, compact), forward(model, twin)
    compact_agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    if not torch.isfinite(got).all() or compact_agree <= 0.999:
        fail(f"compact-format request: finite={bool(torch.isfinite(got).all())}, argmax agreement {compact_agree}")
    print(f"  compact-format request: argmax agreement {compact_agree} with its float32 twin", flush=True)
    return {
        "request_ms": request_ms,
        "reference_request_ms": reference_ms,
        "argmax_agreement": agree,
        "compact_argmax_agreement": compact_agree,
    }


@contextlib.contextmanager
def capturing_accumulator(whole_scene):
    """Keep the (acc, cnt) device accumulators of the scene runs inside the block."""
    saved = whole_scene.accum_scene_logits
    seen: list = []

    def accum(acc, cnt, logits, idx):
        seen.append((acc, cnt))
        return saved(acc, cnt, logits, idx)

    whole_scene.accum_scene_logits = accum
    try:
        yield seen
    finally:
        whole_scene.accum_scene_logits = saved


def scene_run(torch, evaluate, ops, whole_scene, scene, forwards: int, host_counts, label: str):
    """(a): evaluate_scenes over one scene through the kernels; checks the
    launches, the device accumulator and its coverage."""
    want = {name: n * forwards for name, n in SCENE_LAUNCHES.items()}
    ops.reset_launch_counts()
    with capturing_accumulator(whole_scene) as seen:
        t0 = time.perf_counter()
        results = evaluate([scene])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    if counts != want:
        fail(f"scene {label}: kernel launches {counts}, expected {want} ({forwards} forward(s))")
    acc, cnt = seen[-1]
    if not torch.isfinite(acc).all():
        fail(f"scene {label}: non-finite accumulated logits")
    if not torch.equal(cnt.cpu().long(), torch.from_numpy(host_counts)):
        fail(f"scene {label}: device counts differ from the host's np.add.at over the same windows")
    covered = (cnt > 0).float().mean().item()
    if covered <= 0.5:
        fail(f"scene {label}: only {covered:.3f} of the points covered")
    print(f"  evaluate_scenes ({label}): {seconds:.3f} s, launches {counts}, covered {covered:.4f}, "
          f"mIoU {results['miou']:.4f}", flush=True)
    return seconds, covered, results, counts


def scene_kernel_cases(torch, cfg, pts, pix):
    """(b): the per-row FPS against its plain version on the scene path's
    inputs, masked, with npoint > N and on a row that overflows into device
    memory; returns the measure() cases of rows 1 and 5 at the path's shapes.
    pts (4, 102400, 3) chunk points, pix (4, 1228800, 3) pixel refs."""
    from mvpnet_torch.ops import KERNELS, reference

    fps = KERNELS["fps"]
    sa1 = cfg.model.pn2.sa[0]
    k = cfg.model.aggregation.k
    B, M, N = pts.shape[0], pts.shape[1], pix.shape[1]
    g = torch.Generator(device=pts.device).manual_seed(1)
    valid = torch.rand(pts.shape[:2], generator=g, device=pts.device) > 0.1
    valid[:, :3] = False  # the seed must move to the first valid point
    valid[-2, : M // 2] = False
    valid[-1] = False  # no valid point: seed 0, and every step takes index 0
    short = torch.rand((2, 14600, 3), generator=g, device=pts.device) * 6  # just over shared memory
    # the TPU wrapper's longest row: each CTA keeps part of its slice in the
    # device-memory overflow
    longest = torch.rand((1, 1 << 19, 3), generator=g, device=pts.device) * 6
    for name, kern, plain in [
        ("fps_perrow masked", lambda: fps.farthest_point_sample(pts, sa1.npoint, valid),
         lambda: reference.farthest_point_sample(pts, sa1.npoint, valid)),
        ("fps_perrow edges npoint>N", lambda: fps.farthest_point_sample(short, 14650),
         lambda: reference.farthest_point_sample(short, 14650)),
        ("fps_perrow 2^19 points (overflow)", lambda: fps.farthest_point_sample(longest, 1024),
         lambda: reference.farthest_point_sample(longest, 1024)),
    ]:
        same(torch, name, kern(), plain())
        print(f"  {name}: equal", flush=True)
    del longest
    fusion = fusion_case(torch, pts, pix, k, f"{B}x{M} queries over {N} refs, k={k}", subset=FUSION_SUBSET)
    perrow = dict(
        name="fps_perrow", shape=f"{B}x{M} points -> {sa1.npoint} (SA1)", reps=5,
        kern=lambda: fps.farthest_point_sample(pts, sa1.npoint),
        plain=lambda: reference.farthest_point_sample(pts, sa1.npoint), library=None,
        ops=10.0 * B * (sa1.npoint - 1) * M, nbytes=4.0 * (3 * B * M + B * sa1.npoint),
        extra={"cluster": fps.CLUSTER},
    )
    return fusion, perrow


def variant_tiles(name: str, M: int, N: int) -> tuple[int, int]:
    """(tile_m, tile_n) of a gated kernel (knn_gated or knn_resident)."""
    from mvpnet_torch.ops import KERNELS

    mod = KERNELS[name]
    return mod.tiles(M, N)[:2] if name == "knn_gated" else mod.tiles(M)


def gated_case(torch, name, q, r, k, shape, reps=KERNEL_REPS) -> dict:
    """measure() case of a gated kernel (``name``: knn_gated or
    knn_resident) at the full shape, its prep included: it runs on every
    query (the visit order depends on all of them), and the first
    FUSION_SUBSET queries of each row are held against the plain version,
    which cannot sort full rows. The bound counts the pairs these inputs
    need over the prep's tiles (need_pairs, from the kernel's k-th
    distances); the pairs the kernel's gates let through go beside it."""
    from mvpnet_torch.ops import KERNELS, morton

    mod = KERNELS[name]
    B, M, N = q.shape[0], q.shape[1], r.shape[1]
    rows = torch.arange(FUSION_SUBSET, device=q.device)
    scanned = torch.zeros(1, dtype=torch.int64, device=q.device)
    d = mod.knn(q, r, k, scanned=scanned)[0]
    tile_m, tile_n = variant_tiles(name, M, N)
    r_sorted = morton.prepare(q, r, tile_m, tile_n).r_sorted
    need, tiles_a_row = need_pairs(torch, q, d[..., k - 1], [morton.tile_bounds(r_sorted, tile_n)], tile_n)
    del r_sorted, d
    lanes, rows_a_block = mod.layout(B, M, tile_m, tile_n, torch.cuda.get_device_properties(q.device).multi_processor_count)
    print(f"  {name} [{shape}]: layout {lanes} lanes x {rows_a_block} rows; the inputs need {need} pairs "
          f"({tiles_a_row:.3f} tiles a row), the gates let {scanned.item()} through", flush=True)
    return dict(
        name=name, shape=shape, reps=reps,
        kern=lambda: mod.knn(q, r, k),
        check=lambda: tuple(x[:, :FUSION_SUBSET] for x in mod.knn(q, r, k)),
        plain=lambda: mod.plain(q, r, k, rows=rows),
        plain_shape=f"{B}x{FUSION_SUBSET} queries (the first of each row) of the full search",
        library=lambda: cdist_topk(torch, q, r, k), library_once=B * M * N > YARDSTICK_ONCE_PAIRS,
        ops=9.0 * need, ops_scanned=9.0 * scanned.item(), ops_all_pairs=9.0 * B * M * N,
        nbytes=4.0 * (3 * B * M + 3 * B * N + 2 * B * M * k),
        extra={"need_pairs": need, "need_tiles_a_row": tiles_a_row, "scanned_pairs": scanned.item(),
               "lanes": lanes, "rows_a_block": rows_a_block},
    )


def device_launches(torch, fn) -> list[str]:
    """The names of the device activities (kernels, copies, fills) of one
    call of ``fn``, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]


def prep_case(torch, q, r, k) -> dict:
    """The gated kernels' prep (morton.prepare_device, csrc/morton.cu)
    against its plain version (morton.prepare) at row 6's and row 7's tiles
    and with the refs in their order, every output equal; its device
    launches a call (at most PREP_MAX_LAUNCHES, each of csrc/morton.cu's
    kernels among them) beside the plain chain's (prepare and unmap); the
    measure() case at row 6's tiles."""
    from mvpnet_torch.ops import knn_gated, knn_resident, morton

    B, M, N = q.shape[0], q.shape[1], r.shape[1]

    def tensors(p):
        return tuple(x for x in p[:6] if x is not None)

    for label, (tile_m, tile_n), sort_refs in [("row 6 tiles", knn_gated.tiles(M, N)[:2], True),
                                               ("row 7 tiles", knn_resident.tiles(M), True),
                                               ("row 6 tiles, refs in their order", knn_gated.tiles(M, N)[:2], False)]:
        same(torch, f"morton_prep {label}", tensors(morton.prepare_device(q, r, tile_m, tile_n, sort_refs).plain_view()),
             tensors(morton.prepare(q, r, tile_m, tile_n, sort_refs)))
        print(f"  morton_prep {label} ({tile_m} x {tile_n}): equal", flush=True)
    tile_m, tile_n = knn_gated.tiles(M, N)[:2]
    names = device_launches(torch, lambda: morton.prepare_device(q, r, tile_m, tile_n))
    symbols = ("morton_box_kernel", "morton_codes_kernel", "morton_sort_pass_kernel", "morton_gather_kernel",
               "morton_order_kernel")
    if len(names) > PREP_MAX_LAUNCHES or not all(any(s in n for n in names) for s in symbols):
        fail(f"morton_prep: {len(names)} device launches a call, at most {PREP_MAX_LAUNCHES} with {symbols}: {names}")

    def plain_chain():
        p = morton.prepare(q, r, tile_m, tile_n)
        d = torch.zeros((B, p.q_sorted.shape[1], k), device=q.device)
        return morton.unmap(d, d.int(), p.q_order, p.r_order, M, N)

    plain_names = device_launches(torch, plain_chain)
    print(f"  morton_prep: {len(names)} device launches a call ({', '.join(names)}); the plain chain "
          f"(prepare and unmap) {len(plain_names)}", flush=True)
    Mt, Nt = -(-M // tile_m), -(-N // tile_n)
    return dict(
        name="morton_prep", shape=f"{B}x{M} queries and {N} refs, tiles {tile_m} x {tile_n}",
        kern=lambda: morton.prepare_device(q, r, tile_m, tile_n),
        check=lambda: tensors(morton.prepare_device(q, r, tile_m, tile_n).plain_view()),
        plain=lambda: tensors(morton.prepare(q, r, tile_m, tile_n)), plain_shape="the same inputs",
        library=None,
        # the rank of each query tile's bounds: Nt^2 compares
        ops=float(B * Mt * Nt * Nt),
        # read the points, write the tiled points with their index, the ref
        # boxes, the visit order and its bounds
        nbytes=4.0 * (3 * B * (M + N) + 4 * B * (Mt * tile_m + Nt * tile_n) + 6 * B * Nt + 2 * B * Mt * Nt),
        extra={"device_launches": len(names), "device_launch_names": names,
               "plain_device_launches": len(plain_names)},
    )


def scene_phase(torch, evaluate, model, cfg):
    from mvpnet_torch import ops
    from mvpnet_torch.config import load_config
    from mvpnet_torch.data.synthetic import make_scene
    from mvpnet_torch.entry import HIGHRES_CONFIG
    from mvpnet_torch.eval import whole_scene
    from mvpnet_torch.eval.scene_fused import predict_scene_fused
    from mvpnet_torch.eval.sharded_scene import enumerate_scene_chunks

    t0 = time.perf_counter()
    scene = make_scene(SCENE_SEED, **SCENE_SHAPE)
    make_s = time.perf_counter() - t0
    P, C = len(scene.points), cfg.data.num_classes
    chunks = enumerate_scene_chunks(scene, cfg)  # the windows and their point samples, host only
    if len(chunks) != cfg.eval.batch_size:
        fail(f"the scene has {len(chunks)} occupied windows, expected {cfg.eval.batch_size} (one forward)")
    forwards = 1
    host_counts = np.zeros(P, np.int64)
    for sel, _ in chunks:
        np.add.at(host_counts, sel, 1)
    print(f"  scene: {P} points, {len(scene.depth)} frames, {len(chunks)} windows of {cfg.data.num_points} "
          f"points and {cfg.data.num_views_eval} views, made in {make_s:.1f} s", flush=True)

    # (a) evaluate_scenes through the kernels: a first and a second run
    cold_s, covered, results, counts = scene_run(torch, evaluate, ops, whole_scene, scene, forwards, host_counts, "first")
    warm_s, _, _, _ = scene_run(torch, evaluate, ops, whole_scene, scene, forwards, host_counts, "second")
    forward_fn = whole_scene.make_forward(model, cfg)
    forward_ms: list = []

    def timed(batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = forward_fn(batch)
        torch.cuda.synchronize()
        forward_ms.append((time.perf_counter() - t) * 1e3)
        return out

    t0 = time.perf_counter()
    logits = whole_scene.predict_scene(model, cfg, scene, batch_size=cfg.eval.batch_size, forward_fn=timed)
    predict_s = time.perf_counter() - t0
    if logits.shape != (P, C) or not np.isfinite(logits).all():
        fail(f"predict_scene logits {logits.shape}, finite={bool(np.isfinite(logits).all())}")
    print(f"  predict_scene: {predict_s:.3f} s, forward {forward_ms} ms, logits {logits.shape} finite", flush=True)

    # (b) kernels against their plain versions on this path's inputs
    with torch.no_grad():
        pts, pix = scene_fusion_inputs(torch, cfg, scene)
        fusion, perrow = scene_kernel_cases(torch, cfg, pts, pix)
        rows = [measure(torch, fusion), *path_rows(torch, cfg, pts).values(), measure(torch, perrow)]
        # row 6's subgroup-gated body: refs >= 2^18 take tiles of 8192
        k = cfg.model.aggregation.k
        subgate = measure(torch, gated_case(
            torch, "knn_gated", pts, pix, k,
            f"{pts.shape[0]}x{pts.shape[1]} queries over {pix.shape[1]} refs, k={k}, 8-row subgroup gate", reps=3,
        ))
        del pts, pix
    torch.cuda.empty_cache()
    for row in rows:
        row["launches"] = counts[row["name"]] // forwards  # per scene forward, asserted in (a)

    # (c) the scene path through the kernels and through the plain versions,
    # at reduced depth
    cfg_r = load_config(HIGHRES_CONFIG, REDUCED)
    forward_r = whole_scene.make_forward(model, cfg_r)
    ops.reset_launch_counts()
    with recording(ops) as got_log:
        got = whole_scene.predict_scene(model, cfg_r, scene, batch_size=cfg_r.eval.batch_size, forward_fn=forward_r)
    counts_r = ops.launch_counts()
    if counts_r != SCENE_LAUNCHES:
        fail(f"reduced scene: kernel launches {counts_r}, expected {SCENE_LAUNCHES}")
    ops.set_impl("reference")
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with recording(ops) as want_log:
            want = whole_scene.predict_scene(model, cfg_r, scene, batch_size=cfg_r.eval.batch_size, forward_fn=forward_r)
        reference_s = time.perf_counter() - t0
        if any(ops.launch_counts().values()):
            fail(f"reference scene launched kernels: {ops.launch_counts()}")
    finally:
        ops.set_impl("auto")
    n_equal = compare_logs(torch, got_log, want_log, "reduced scene")
    agree = float((got.argmax(1) == want.argmax(1)).mean())
    if agree <= 0.999:
        fail(f"reduced scene: argmax agreement with the reference path {agree}")
    print(f"  reduced scene ({', '.join(REDUCED)}): launches {counts_r}, reference path {reference_s:.3f} s, "
          f"{n_equal} index-op outputs equal, argmax agreement {agree}", flush=True)

    # (d) the fused estimator at config #4
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    fused_results = evaluate([scene], fused=True)
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    fused_counts = ops.launch_counts()
    fused_logits = predict_scene_fused(model, cfg, scene)
    if fused_logits.shape != (P, C) or not np.isfinite(fused_logits).all():
        fail(f"fused estimator logits {fused_logits.shape}, finite={bool(np.isfinite(fused_logits).all())}")
    print(f"  evaluate_scenes(fused=True): {fused_s:.3f} s, launches {fused_counts}, logits finite, "
          f"mIoU {fused_results['miou']:.4f}", flush=True)
    with torch.no_grad():
        fused_row = measure(torch, fused_prepared_case(torch, model, cfg, scene))
    fused_row["launches"] = fused_counts["knn_fusion"]  # per fused scene (one group of windows)

    # (e) where row 1's two modes cross
    with torch.no_grad():
        crossing = crossover(torch, scene)
    summary = {
        "config": os.path.relpath(HIGHRES_CONFIG, os.path.dirname(os.path.abspath(__file__))),
        "scene": {"seed": SCENE_SEED, **SCENE_SHAPE, "windows": len(chunks), "make_s": make_s},
        "evaluate_s": [cold_s, warm_s],
        "predict_scene_s": predict_s,
        "forward_ms": forward_ms,
        "launches_per_forward": {k: v // forwards for k, v in counts.items()},
        "covered": covered,
        "miou": results["miou"],
        "reduced": REDUCED,
        "reduced_launches": counts_r,
        "reduced_reference_s": reference_s,
        "reduced_index_outputs_equal": n_equal,
        "reduced_argmax_agreement": agree,
        "fused_s": fused_s,
        "fused_launches": fused_counts,
        "fused_miou": fused_results["miou"],
        "crossover": crossing,
    }
    return summary, rows, subgate, fused_row


def scene_fusion_inputs(torch, cfg, scene):
    """The fusion kNN's inputs of one forward over the scene's windows at
    ``cfg``: chunk points (B, N, 3) and pixel refs (B, V * H * W, 3) on the
    card."""
    from mvpnet_torch.data.pipeline import collate
    from mvpnet_torch.entry import to_device
    from mvpnet_torch.eval import whole_scene
    from mvpnet_torch.train.step import prepare_batch

    centers = whole_scene.enumerate_chunk_centers(scene.points, cfg.data.chunk_size, cfg.data.chunk_stride)
    samples = list(whole_scene._iter_scene_samples(scene, cfg, centers, 0))
    for s in samples:
        s.pop("point_idx")
        s.pop("colors")
    batch = prepare_batch(cfg, to_device(collate(samples), "cuda"), training=False)
    pts = batch["points"].float().contiguous()
    return pts, batch["image_xyz"].reshape(pts.shape[0], -1, 3).contiguous()


def crossover(torch, scene) -> list[dict]:
    """(e): row 1 in both modes at the CROSSOVER shapes, on the scene's
    windows: each mode equal to the plain version on the first FUSION_SUBSET
    queries of each row and timed with its prep; the route's mode beside the
    faster one."""
    from mvpnet_torch.config import load_config
    from mvpnet_torch.entry import HIGHRES_CONFIG
    from mvpnet_torch.ops import KERNELS

    fusion = KERNELS["knn_fusion"]
    out = []
    for n_points, views in CROSSOVER:
        cfg = load_config(HIGHRES_CONFIG, [f"data.num_points={n_points}", f"data.num_views_eval={views}"])
        pts, pix = scene_fusion_inputs(torch, cfg, scene)
        B, M, N = pts.shape[0], pts.shape[1], pix.shape[1]
        k = cfg.model.aggregation.k
        modes = fusion_case(torch, pts, pix, k, f"{B}x{M} queries over {N} refs, k={k}", subset=FUSION_SUBSET)["extra"]["modes"]
        ms = {m: v["ms"] for m, v in modes.items()}
        row = {"num_points": n_points, "views": views, "pairs": B * M * N, "route": fusion.route(B, M, N),
               "faster": min(ms, key=ms.get), "brute_ms": ms["brute"], "demand_ms": ms["demand"],
               "demand_scanned_fraction": modes["demand"]["scanned_fraction"]}
        print(f"  crossover {B}x{M} queries over {N} refs ({row['pairs']:.3g} pairs): brute {ms['brute']:.4f} ms, "
              f"demand {ms['demand']:.4f} ms; faster {row['faster']}, route {row['route']}", flush=True)
        out.append(row)
        del pts, pix
        torch.cuda.empty_cache()
    return out


def fused_prepared_case(torch, model, cfg, scene) -> dict:
    """(d): row 1 through knn_prepared on the fused estimator's inputs: the
    scene's prepared pixel cloud (ops.knn_prepare) and the first group of
    chunk windows as one query set, as predict_scene_fused runs them."""
    from mvpnet_torch import ops
    from mvpnet_torch.eval.scene_fused import build_scene_fused_fns
    from mvpnet_torch.eval.sharded_scene import enumerate_scene_chunks, select_scene_views

    pixel_fn, _, _ = build_scene_fused_fns(model, cfg)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()

    frames = select_scene_views(scene, min(cfg.eval.scene_views, len(scene.depth)))
    pixel_xyz, _ = pixel_fn(put(scene.rgb[frames]), put(scene.depth[frames]), put(scene.poses[frames]),
                            put(scene.intrinsics))
    group = enumerate_scene_chunks(scene, cfg)[: cfg.eval.batch_size]
    q = put(np.stack([c[1] for c in group])).reshape(1, -1, 3)
    prepared = ops.knn_prepare(pixel_xyz)
    k = cfg.model.aggregation.k
    return fusion_case(torch, q, pixel_xyz, k, f"knn_prepared: 1x{q.shape[1]} queries over the scene's "
                       f"prepared cloud of {pixel_xyz.shape[1]} refs, k={k}", subset=FUSION_SUBSET, prepared=prepared)


def train_steps(torch, ops, step, batches, model, optimizer, accum: int, launches=TRAIN_LAUNCHES,
                label: str = "") -> dict:
    """(a): TRAIN_STEPS steps of train_entry's step; each must launch every
    kernel of the path the expected number of times (``launches`` a
    microbatch) and give a finite loss; BN statistics and parameters must
    move."""
    want = {name: n * accum for name, n in launches.items()}
    label = label or f"grad_accum={accum}"
    bn = [m for m in model.modules() if type(m).__name__ == "BatchNorm"]
    stats0 = [m.running_mean.clone() for m in bn]
    params0 = [p.detach().clone() for p in optimizer.params]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, wait_ms, losses = [], [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        batch = next(batches)
        t1 = time.perf_counter()
        ops.reset_launch_counts()
        m = step(batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        wait_ms.append((t1 - t0) * 1e3)
        losses.append(loss)
        if counts != want:
            fail(f"train step {i} ({label}): kernel launches {counts}, expected {want}")
        if not np.isfinite(loss):
            fail(f"train step {i} ({label}): loss {loss}")
    peak = torch.cuda.max_memory_allocated()
    moved_bn = sum(not torch.equal(m.running_mean, s0) for m, s0 in zip(bn, stats0))
    moved = sum(not torch.equal(p, p0) for p, p0 in zip(optimizer.params, params0))
    if moved_bn < len(bn) or moved < 0.99 * len(params0):
        fail(f"{label}: {moved_bn}/{len(bn)} BN running means and {moved}/{len(params0)} parameters moved")
    B = next(iter(batch.values())).shape[0]
    warm = statistics.median(step_ms[1:])
    print(f"  {label}: {TRAIN_STEPS} steps, launches {counts} a step, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, step ms median {warm:.2f} (first {step_ms[0]:.2f}), data wait median "
          f"{statistics.median(wait_ms):.2f} ms, {B / (warm + statistics.median(wait_ms)) * 1e3:.2f} samples/s, "
          f"peak memory {peak / 2**30:.2f} GiB; {moved_bn}/{len(bn)} BN running means and "
          f"{moved}/{len(params0)} parameter tensors moved", flush=True)
    return {
        "grad_accum": accum, "step_ms": step_ms, "data_wait_ms": wait_ms, "losses": losses,
        "chunks_per_s": B / ((warm + statistics.median(wait_ms)) / 1e3), "peak_memory_gib": peak / 2**30,
        "launches_per_step": counts,
    }


def checkpoint_round_trip(torch, model, optimizer) -> None:
    """Save, disturb every tensor, restore: the model and the optimizer come
    back exactly."""
    import shutil

    from mvpnet_torch.train.checkpoint import Checkpointer

    directory = os.path.join(os.path.dirname(os.path.abspath(__file__)), "outputs", "chip_smoke_checkpoint")
    shutil.rmtree(directory, ignore_errors=True)
    try:
        ckpt = Checkpointer(directory, keep=1)
        ckpt.save(optimizer.count - 1, model, optimizer)
        want = {k: v.clone() for k, v in model.state_dict().items()}
        want_opt = [s["exp_avg"].clone() for s in optimizer.inner.state.values()]
        count = optimizer.count
        with torch.no_grad():
            for v in model.state_dict().values():
                v.add_(1)
            for s in optimizer.inner.state.values():
                s["exp_avg"].add_(1.0)
        optimizer.count += 5
        if ckpt.restore(model, optimizer) != count - 1:
            fail("checkpoint: restore found another step")
        bad = [k for k, v in model.state_dict().items() if not torch.equal(v, want[k])]
        opt_ok = all(torch.equal(s["exp_avg"], w) for s, w in zip(optimizer.inner.state.values(), want_opt))
        if bad or not opt_ok or optimizer.count != count:
            fail(f"checkpoint round trip: {len(bad)} model tensors differ, optimizer equal={opt_ok}")
        print(f"  checkpoint round trip: {len(want)} model tensors and the optimizer state restored exactly", flush=True)
    finally:
        shutil.rmtree(directory, ignore_errors=True)


def first_step_again(torch, ops, cfg, model, init_state, batch, loss_fn, metric_fn):
    """One train step on ``batch`` from ``init_state``, reproducibly: the
    dropout masks and the augmentation draws start again from their seeds,
    with a fresh optimizer. Returns (loss, index-op log, launch counts)."""
    from mvpnet_torch.models.blocks import Dropout
    from mvpnet_torch.train.solver import build_optimizer
    from mvpnet_torch.train.step import make_train_step

    model.load_state_dict(init_state)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = None
    optimizer = build_optimizer(cfg.solver, [p for p in model.parameters() if p.requires_grad])
    ops.reset_launch_counts()
    with recording(ops) as log:
        loss = float(make_train_step(cfg, loss_fn, metric_fn)(model, optimizer, batch, torch.Generator().manual_seed(0))["loss"])
    torch.cuda.synchronize()
    return loss, log, ops.launch_counts()


def variant_steps(torch, ops, cfg, model, init_state, batch, loss_fn, metric_fn) -> dict:
    """(c): the first train step again from the same weights and batch, with
    the fusion kNN on each variant: each launches its kernel once, and gives
    the default route's fusion indices and loss."""
    out, launches = {}, {}
    try:
        for variant, kernel in VARIANT_KERNEL.items():
            ops.set_fusion_variant(variant)
            loss, log, counts = first_step_again(torch, ops, cfg, model, init_state, batch, loss_fn, metric_fn)
            want = dict(TRAIN_LAUNCHES, knn_fusion=0)
            want[kernel] = 1
            if kernel != "knn_fusion":  # rows 6 and 7 prepare on the card
                want["morton_prep"] = 1
            if counts != want:
                fail(f"variant {variant}: kernel launches {counts}, expected {want}")
            fusion_idx = next(o for n, o in log if n == "knn")[1]
            out[variant] = (loss, fusion_idx)
            launches[kernel] = counts[kernel]
            launches["morton_prep"] = counts["morton_prep"]
    finally:
        ops.set_fusion_variant("demand")
    loss0, idx0 = out["demand"]
    for variant, (loss, idx) in out.items():
        if not torch.equal(idx, idx0):
            fail(f"variant {variant}: fusion indices differ from the default route's in {(idx != idx0).sum().item()} places")
        if abs(loss - loss0) > 1e-6 * abs(loss0):
            fail(f"variant {variant}: loss {loss} vs {loss0} on the default route")
    print(f"  first step on each fusion variant: losses {[v[0] for v in out.values()]}, fusion indices equal, "
          f"launches {launches}", flush=True)
    return {"losses": {v: o[0] for v, o in out.items()}, "launches": launches}


def train_phase(torch):
    """The train path at the training config: (a) steps with grad_accum 1,
    a checkpoint round trip, then steps with grad_accum 2; (b) rows 6 and 7
    against their plain versions on the first batch's fusion inputs, timed
    beside row 1; (c) the first step again on each fusion variant."""
    from mvpnet_torch import ops
    from mvpnet_torch.config import load_config
    from mvpnet_torch.entry import TRAIN_CONFIG, TRAIN_OVERRIDES, train_entry
    from mvpnet_torch.models.build import loss_and_metrics

    summary = {"config": os.path.relpath(TRAIN_CONFIG, os.path.dirname(os.path.abspath(__file__))),
               "overrides": TRAIN_OVERRIDES}
    cfg = load_config(TRAIN_CONFIG, TRAIN_OVERRIDES)
    step, (model, optimizer, batches) = train_entry(cfg=cfg, seed=0)
    try:
        first = next(batches)
        init_state = {k: v.clone() for k, v in model.state_dict().items()}
        summary["steps"] = [train_steps(torch, ops, step, batches, model, optimizer, 1)]
    finally:
        batches.close()
    checkpoint_round_trip(torch, model, optimizer)
    summary["variants"] = variant_steps(torch, ops, cfg, model, init_state, first, *loss_and_metrics(cfg))
    rows = train_kernel_rows(torch, cfg, first)
    for name in ("knn_fusion", "fps", "ball_query", "knn"):
        rows[name]["launches"] = summary["steps"][0]["launches_per_step"][name]
    for name in ("knn_gated", "knn_resident", "morton_prep"):
        rows[name]["launches"] = summary["variants"]["launches"][name]
    del step, model, optimizer, batches, init_state, first
    torch.cuda.empty_cache()

    cfg = load_config(TRAIN_CONFIG, TRAIN_OVERRIDES + ["train.grad_accum=2"])
    step, (model, optimizer, batches) = train_entry(cfg=cfg, seed=0)
    try:
        summary["steps"].append(train_steps(torch, ops, step, batches, model, optimizer, 2))
    finally:
        batches.close()
    return summary, rows


def train_kernel_rows(torch, cfg, batch) -> dict:
    """(b): rows 6 and 7 on the batch's fusion inputs (the synthetic depth's
    holes are sentinel pixels), with masked refs, duplicate points, a batch
    of 2 and the refs kept in their order (refs_coherent), each at every
    layout of lanes 1 to 32 (rows a block as the layout rule gives them);
    their prep against its plain version; then each timed beside row 1 at
    the train shape."""
    from mvpnet_torch.ops import KERNELS, knn_gated, reference
    from mvpnet_torch.train.step import prepare_batch

    with torch.no_grad():
        mb = prepare_batch(cfg, batch, training=True, generator=torch.Generator().manual_seed(0))
        pts = mb["points"].float().contiguous()
        pix = mb["image_xyz"].reshape(pts.shape[0], -1, 3).contiguous()
        del mb
        k = cfg.model.aggregation.k
        B, M, N = pts.shape[0], pts.shape[1], pix.shape[1]
        print(f"  fusion inputs: {B}x{M} points, {N} pixels a row, "
              f"{(pix.abs() >= 1e5).any(-1).float().mean().item():.4f} of them sentinels", flush=True)
        g = torch.Generator(device=pts.device).manual_seed(2)
        masked = reference.mask_points(pix, torch.rand(pix.shape[:2], generator=g, device=pix.device) > 0.2)
        dup = pix.clone()
        dup[:, N // 2 : 2 * (N // 2)] = pix[:, : N // 2]
        rows = torch.arange(FUSION_SUBSET, device=pts.device)
        cases = [("masked refs", pts, masked, True), ("duplicate points", pts, dup, True),
                 ("batch of 2", pts[:2].contiguous(), pix[:2].contiguous(), True),
                 ("refs in their order", pts, pix, False)]
        for name in ("knn_gated", "knn_resident"):
            mod = KERNELS[name]
            tile_m = variant_tiles(name, M, N)[0]
            for label, q, r, sort_refs in cases:
                want = mod.plain(q, r, k, rows=rows, sort_refs=sort_refs)
                lanes = 1
                while lanes <= knn_gated.MAX_LANES:
                    rows_a_block = min(tile_m, knn_gated.MAX_THREADS // lanes)
                    got = mod.knn_at(q, r, k, lanes, rows_a_block, sort_refs=sort_refs)
                    same(torch, f"{name} {label} lanes={lanes}", tuple(x[:, :FUSION_SUBSET] for x in got), want)
                    lanes *= 2
                got = mod.knn(q, r, k, sort_refs=sort_refs)  # the layout rule's
                same(torch, f"{name} {label}", tuple(x[:, :FUSION_SUBSET] for x in got), want)
                print(f"  {name} {label}: equal at lanes 1-{knn_gated.MAX_LANES} and at the layout rule's", flush=True)
        del masked, dup
        shape = f"{B}x{M} queries over {N} refs, k={k}"
        out = {name: measure(torch, gated_case(torch, name, pts, pix, k, shape)) for name in ("knn_gated", "knn_resident")}
        out["morton_prep"] = measure(torch, prep_case(torch, pts, pix, k))
        out["knn_fusion"] = measure(torch, fusion_case(torch, pts, pix, k, shape, subset=FUSION_SUBSET))
        out.update(path_rows(torch, cfg, pts))  # rows 2-4 at the train step's shapes
    return out


def reference_step(torch, ops, cfg, model, init_state, batch, loss_fn, metric_fn, launches: dict) -> dict:
    """(b): the first step again from the same weights and batch, through
    the kernels (``launches``) and through the plain versions (none): equal
    index-op outputs and the same loss."""
    out = {}
    try:
        for impl in ("auto", "reference"):
            ops.set_impl(impl)
            loss, log, counts = first_step_again(torch, ops, cfg, model, init_state, batch, loss_fn, metric_fn)
            want = launches if impl == "auto" else dict.fromkeys(launches, 0)
            if counts != want:
                fail(f"{cfg.model.name} first step ({impl}): kernel launches {counts}, expected {want}")
            out[impl] = (loss, log)
    finally:
        ops.set_impl("auto")
    n_equal = compare_logs(torch, out["auto"][1], out["reference"][1], f"{cfg.model.name} first step")
    loss, ref_loss = out["auto"][0], out["reference"][0]
    if not np.isfinite(loss) or abs(loss - ref_loss) > 1e-6 * abs(ref_loss):
        fail(f"first step: loss {loss} through the kernels, {ref_loss} through the plain versions")
    print(f"  first step again through the plain versions: {n_equal} index-op outputs equal, "
          f"loss {loss} and {ref_loss}", flush=True)
    return {"index_op_outputs_equal": n_equal, "loss": loss, "reference_loss": ref_loss}


def recipe_train(torch, ops, cfg, launches: dict, label: str, repeat: bool) -> dict:
    """``train_entry`` at ``cfg``: TRAIN_STEPS steps through train_steps;
    with ``repeat`` the first step again through the plain versions."""
    from mvpnet_torch.entry import train_entry
    from mvpnet_torch.models.build import loss_and_metrics

    step, (model, optimizer, batches) = train_entry(cfg=cfg, seed=0)
    try:
        first = next(batches)
        init_state = {k: v.clone() for k, v in model.state_dict().items()}
        out = train_steps(torch, ops, step, batches, model, optimizer, 1, launches=launches, label=label)
    finally:
        batches.close()
    out["batch"] = {k: [list(v.shape), str(v.dtype)] for k, v in first.items()}
    if repeat:
        out["reference_step"] = reference_step(torch, ops, cfg, model, init_state, first, *loss_and_metrics(cfg),
                                               launches=launches)
    del step, model, optimizer, batches, init_state, first
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def counting_forwards(torch, ops, whole_scene, what: str):
    """Record each whole-scene forward's kernel launches and batch keys. The
    first forward also runs again on its batch through the plain versions
    (launching nothing): equal index-op outputs and the same argmax, so the
    kernels are held at the shapes this path gives them."""
    make_forward = whole_scene.make_forward
    log: list = []
    reference: dict = {}

    def counted(model, cfg):
        forward_fn = make_forward(model, cfg)

        def inner(batch):
            first = not log
            ops.reset_launch_counts()
            with recording(ops) if first else contextlib.nullcontext() as got_log:
                out = forward_fn(batch)
            torch.cuda.synchronize()
            log.append((ops.launch_counts(), sorted(batch)))
            if first:
                reference.update(reference_forward(torch, ops, forward_fn, batch, out, got_log, what))
            return out
        return inner

    whole_scene.make_forward = counted
    try:
        yield log, reference
    finally:
        whole_scene.make_forward = make_forward


def reference_forward(torch, ops, forward_fn, batch, got, got_log, what: str) -> dict:
    """``batch`` again through the plain versions; compared with the kernels' run."""
    ops.set_impl("reference")
    try:
        ops.reset_launch_counts()
        with recording(ops) as want_log:
            want = forward_fn(batch)
        torch.cuda.synchronize()
        if any(ops.launch_counts().values()):
            fail(f"{what} reference forward launched kernels: {ops.launch_counts()}")
    finally:
        ops.set_impl("auto")
    n_equal = compare_logs(torch, got_log, want_log, what)
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    if agree <= 0.999:
        fail(f"{what}: argmax agreement with the reference forward {agree}")
    shapes = {n: [list(o.shape) for o in outs] for n, outs in reversed(got_log)}  # each op's first call
    return {"index_op_outputs_equal": n_equal, "argmax_agreement": agree, "first_output_shapes": shapes}


def cli_json(main, argv) -> dict:
    """Run a CLI's main; its last line of standard output as JSON."""
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    lines = out.getvalue().strip().splitlines()
    if not lines:
        fail(f"{argv}: printed nothing")
    return json.loads(lines[-1])


def test_3d_run(torch, ops, cfg_path, overrides, launches: dict, export=None) -> dict:
    """cli.test_3d over the synthetic val scenes: a finite mIoU in [0, 1],
    each forward launching ``launches``, the first one held against the
    plain versions, colors in the batch where the config ships them; with
    ``export``, one NYU40 file a scene with a label a point."""
    from mvpnet_torch.cli import test_3d
    from mvpnet_torch.config import load_config
    from mvpnet_torch.data.pipeline import build_dataset
    from mvpnet_torch.eval import whole_scene

    cfg = load_config(cfg_path, overrides)
    argv = ["--cfg", cfg_path] + (["--export", export] if export else []) + overrides
    what = f"test_3d {cfg.model.name}"
    t0 = time.perf_counter()
    with counting_forwards(torch, ops, whole_scene, what) as (log, reference):
        results = cli_json(test_3d.main, argv)
    seconds = time.perf_counter() - t0
    if not log or not reference:
        fail(f"{what}: {len(log)} forwards, reference check {reference}")
    for i, (counts, keys) in enumerate(log):
        if counts != launches:
            fail(f"{what} forward {i}: kernel launches {counts}, expected {launches}")
        if ("colors" in keys) != cfg.data.include_colors:
            fail(f"{what} forward {i}: batch keys {keys}, include_colors={cfg.data.include_colors}")
    miou = results.get("miou")
    if miou is None or not np.isfinite(miou) or not 0.0 <= miou <= 1.0:
        fail(f"{what}: results {results}")
    out = {"miou": miou, "accuracy": results["accuracy"], "forwards": len(log), "launches_per_forward": log[0][0],
           "reference_forward": reference, "seconds": seconds}
    if export:
        scenes = build_dataset(cfg.data, batch_size=1, training=False).scenes
        want = {f"{s.name}.txt": len(s.points) for s in scenes}
        got = {}
        for f in sorted(os.listdir(export)):
            with open(os.path.join(export, f)) as fh:
                got[f] = sum(1 for _ in fh)
        if got != want:
            fail(f"test_3d --export wrote {got}, expected {want}")
        out["export"] = got
    print(f"  {what}: mIoU {miou:.4f}, {len(log)} forwards each launching {log[0][0]}, "
          f"{seconds:.1f} s" + (f", export {out['export']}" if export else ""), flush=True)
    print(f"  {what} first forward again through the plain versions: {reference['index_op_outputs_equal']} "
          f"index-op outputs equal, argmax agreement {reference['argmax_agreement']}; first output shapes "
          f"{reference['first_output_shapes']}", flush=True)
    return out


def recipe_cli(torch, ops, directory: str) -> dict:
    """(c): train_2d -> train_3d warm-started from it -> test_3d --export;
    train_3d and test_3d on pn2ssg_rgb; test_2d on the 2D run."""
    from mvpnet_torch.cli import test_2d, train_2d, train_3d
    from mvpnet_torch.entry import TRAIN_CONFIG

    run = ["train.log_every=1", "train.val_steps=1"]
    d2, d3, drgb = (os.path.join(directory, n) for n in ("sem_seg_2d", "mvpnet_3d", "pn2ssg_rgb"))
    out = {}
    t0 = time.perf_counter()
    train_2d.main(["--cfg", CONFIG_2D, *SYNTHETIC, *run, f"train.max_steps={CLI_STEPS}", f"output_dir={d2}"])
    ckpt_2d = os.path.join(d2, "checkpoints", str(CLI_STEPS - 1), "state.pt")
    if not os.path.exists(ckpt_2d):
        fail(f"train_2d wrote no checkpoint at {ckpt_2d}")
    out["train_2d_s"] = time.perf_counter() - t0

    # the warm start, read before any step (max_steps=0), then the run
    warm = [*SYNTHETIC, *run, f"model.pretrained_2d={d2}/checkpoints", f"output_dir={d3}"]
    model, _ = train_3d.main(["--cfg", TRAIN_CONFIG, *warm, "train.max_steps=0"])
    state = torch.load(ckpt_2d, map_location="cpu", weights_only=True)["model"]
    net_2d = {k: v.cpu() for k, v in model.net_2d.state_dict().items()}
    bad = [k for k, v in net_2d.items() if not torch.equal(v, state["net_2d." + k])]
    if bad or len(net_2d) != sum(k.startswith("net_2d.") for k in state):
        fail(f"train_3d warm start: {len(bad)} of {len(net_2d)} net_2d tensors differ from the 2D checkpoint")
    del model
    print(f"  train_3d warm start: {len(net_2d)} net_2d tensors equal the 2D checkpoint's", flush=True)
    t0 = time.perf_counter()
    _, val = train_3d.main(["--cfg", TRAIN_CONFIG, *warm, f"train.max_steps={CLI_STEPS}"])
    out["train_3d_s"] = time.perf_counter() - t0
    out["train_3d_val_miou"] = val["miou"]
    out["test_3d"] = test_3d_run(torch, ops, TRAIN_CONFIG, [*SYNTHETIC, f"output_dir={d3}"], EXPECTED_LAUNCHES,
                                 export=os.path.join(directory, "export"))

    rgb = BASELINE_CONFIGS["pn2ssg_rgb"]
    train_3d.main(["--cfg", rgb, *SYNTHETIC, *run, f"train.max_steps={CLI_STEPS}", f"output_dir={drgb}"])
    out["test_3d_pn2ssg_rgb"] = test_3d_run(torch, ops, rgb, [*SYNTHETIC, f"output_dir={drgb}"], BASELINE_LAUNCHES)

    ops.reset_launch_counts()
    results = cli_json(test_2d.main, ["--cfg", CONFIG_2D, *SYNTHETIC, f"output_dir={d2}"])
    if not np.isfinite(results.get("miou", np.nan)) or any(ops.launch_counts().values()):
        fail(f"test_2d: results {results}, launches {ops.launch_counts()}")
    out["test_2d"] = {"miou": results["miou"], "accuracy": results["accuracy"]}
    print(f"  test_2d: mIoU {results['miou']:.4f}, accuracy {results['accuracy']:.4f}", flush=True)
    return out


def recipe_phase(torch) -> dict:
    """7: the paper's recipe: (a) the 2D pretraining path, (b) the
    PointNet++ baselines, (c) the command lines end to end."""
    import shutil

    from mvpnet_torch import ops
    from mvpnet_torch.config import load_config

    t0 = time.perf_counter()
    summary = {}
    cfg = load_config(CONFIG_2D, SYNTHETIC + ["data.sampling=frames"])
    summary["sem_seg_2d"] = recipe_train(torch, ops, cfg, RECIPE_2D_LAUNCHES, "sem_seg_2d", repeat=False)
    for name, path in BASELINE_CONFIGS.items():
        cfg = load_config(path, SYNTHETIC)
        summary[name] = recipe_train(torch, ops, cfg, BASELINE_LAUNCHES, name, repeat=True)
    if "colors" not in summary["pn2ssg_rgb"]["batch"] or "colors" in summary["pn2ssg_xyz"]["batch"]:
        fail(f"pn2ssg batches: rgb {summary['pn2ssg_rgb']['batch']}, xyz {summary['pn2ssg_xyz']['batch']}")
    directory = os.path.join(os.path.dirname(os.path.abspath(__file__)), "outputs", "chip_smoke_recipe")
    shutil.rmtree(directory, ignore_errors=True)
    try:
        summary["cli"] = recipe_cli(torch, ops, directory)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    summary["seconds"] = time.perf_counter() - t0
    print(f"  recipe phase: {summary['seconds']:.1f} s", flush=True)
    return summary


def recipe_launches(summary: dict, name: str) -> dict:
    """A kernel's launches on each path of the recipe phase."""
    return {
        "sem_seg_2d_step": summary["sem_seg_2d"]["launches_per_step"][name],
        "pn2ssg_xyz_step": summary["pn2ssg_xyz"]["launches_per_step"][name],
        "pn2ssg_rgb_step": summary["pn2ssg_rgb"]["launches_per_step"][name],
        "test_3d_mvpnet_3d_forward": summary["cli"]["test_3d"]["launches_per_forward"][name],
        "test_3d_pn2ssg_rgb_forward": summary["cli"]["test_3d_pn2ssg_rgb"]["launches_per_forward"][name],
    }


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a CUDA card")
    from mvpnet_torch.config import Config
    from mvpnet_torch.entry import entry, scene_entry, to_device
    from mvpnet_torch.ops import _cuda
    from mvpnet_torch.train.step import prepare_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    _cuda.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(_cuda.SOURCES)} kernels", flush=True)

    cfg = Config()
    forward, (model, batch) = entry()
    print("kernel phase:", flush=True)
    with torch.no_grad():
        prepared = prepare_batch(cfg, to_device(batch, "cuda"), training=False)
        chunk_rows = kernel_phase(torch, cfg, prepared)
    print("slice phase:", flush=True)
    summary = slice_phase(torch, forward, model, cfg, chunk_rows)
    del forward, model, batch, prepared
    torch.cuda.empty_cache()
    print("scene phase:", flush=True)
    evaluate, (scene_model, scene_cfg) = scene_entry()
    scene_summary, rows, subgate, fused_row = scene_phase(torch, evaluate, scene_model, scene_cfg)
    del evaluate, scene_model
    torch.cuda.empty_cache()
    print("train phase:", flush=True)
    train_summary, train_rows = train_phase(torch)
    torch.cuda.empty_cache()
    print("recipe phase:", flush=True)
    recipe = recipe_phase(torch)

    def path(row):  # a row's numbers, nested under another row of the same kernel
        return {k: v for k, v in row.items() if k not in ("name", "route", "source", "replaces")}

    chunk = {row["name"]: row for row in chunk_rows}
    for row in rows:  # the chunk path's numbers of the kernels it runs
        if row["name"] in chunk:
            row["chunk_path"] = path(chunk[row["name"]])
    for row in rows:  # the train path's and the fused estimator's numbers
        if row["name"] in train_rows:
            row["train_path"] = path(train_rows[row["name"]])
        if row["name"] == "knn_fusion":
            row["fused_path"] = path(fused_row)
    subgate["launches"] = 0  # the scene path's fusion kNN is row 1
    train_rows["knn_gated"]["scene_path"] = path(subgate)
    rows += [train_rows["knn_gated"], train_rows["knn_resident"], train_rows["morton_prep"]]
    for row in rows:
        row["recipe_launches"] = recipe_launches(recipe, row["name"])
    print(json.dumps({"slice": summary}), flush=True)
    print(json.dumps({"scene": scene_summary}), flush=True)
    print(json.dumps({"train": train_summary}), flush=True)
    print(json.dumps({"recipe": recipe}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card_line(), flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
