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
           on the 2D run prints its results;
       (d) the deployment path on the mvpnet_3d run of (c), before its
           directory goes: cli.export_3d --batch-size 1 --check (the
           torch.export artifact against the eager forward, JAX's margin
           rule), the loaded program's mvpnet:: nodes (knn_fusion 1, fps 4,
           ball_query 4, knn 4, no other), then cli.serve_3d on port 0:
           /healthz, /meta, 5 /predict requests each launching the chunk
           path's kernels and meeting the --check rule against the eager
           forward, the first also against the plain versions, and a junk
           body answered 400 with the server up after it; prints the
           export seconds, the artifact's MB and the /predict and eager
           forward host ms.
     It prints the {"recipe": ...} line and its seconds, then the
     {"serve": ...} line of (d).
  8. dist: the multi-device layer (mvpnet_torch/dist) on the one card:
       (a) cli.train_3d under python -m torch.distributed.run --standalone
           --nproc_per_node 1 at the training config (mesh.data=1, 3 steps,
           one validation batch) in the deterministic mode
           (train.deterministic, CUBLAS_WORKSPACE_CONFIG in its
           environment): its log must name backend nccl, world 1, device
           cuda:0, its kernel launches must be the chunk path's a forward,
           and its step losses must equal two in-process train() runs of the
           same config, the first step bit for bit and the rest within
           DIST_LOSS_RTOL, while the two in-process runs must be equal bit
           for bit; two in-process runs in the default mode print their
           spread; train_entry's step timed in both modes; then
           cli.test_3d --sharded (mesh.space=1) under the launcher on that
           run prints a mIoU;
       (b) the ring of dist/fusion.py on the loopback mesh at space 2 and 4
           over the training config's sharded-scene shapes (4 windows of
           8192 points a shard, the 12-view set of a synthetic validation
           scene: 230,400 refs in blocks of 115,200 or 57,600): S^2 launches
           of row 1 a pass, distances and picks equal bit for bit to the
           unsharded ops.knn; a hop, the unsharded search and a pass timed;
       (c) predict_scene_sharded on the loopback mesh at space 2 with (a)'s
           weights on that scene against predict_scene_fused: its launches
           a pass and ms a pass, both estimators' agreement in bf16 held to
           cli.export_3d's margin rule with a tie band of a few bf16 grid
           steps at the top logit (on 3-step weights the logits reach
           1e3-1e5, where bf16 rounding exceeds the rule's absolute band),
           then in f32 on the same weights held to the rule as it is.
     It prints the {"dist": ...} line.
  9. shapes: configs #3 and #4 at their shapes through
     mvpnet_torch.config_shapes (the launch counts set to 0 before each step
     and asserted after it):
       (a) config #3 (configs/scannet/mvpnet_3d_32k_chunks.yaml on synthetic
           data: B=32 as 4 x B8, N=32,768, V=3; example_batch seed 0, seeded
           weights) with train.remat off and on: SHAPES_STEPS steps each,
           launching 4 / 4 / 12 / 16 / 16 a step (knn_fusion in its demand
           mode / fps_perrow / fps / ball query / three-NN); step ms,
           chunks/s, peak memory;
       (b) the first microbatch of (a)'s batch, forward and backward from
           the same weights in the deterministic mode, through the kernels
           and with set_impl("reference"), with remat off and on: equal index-op
           outputs, loss and logits within PARITY_LOGITS_ABS (cosine >
           PARITY_LOGITS_COS), every gradient to cosine > PARITY_GRAD_COS
           with its norm within PARITY_GRAD_NORM;
       (c) train_entry() at config #3 on synthetic scenes (its chunks drawn
           with replacement: exact duplicate points), its first microbatch
           held as in (b); on that microbatch row 1 in its demand mode on
           the batch's pixel cloud (the first FUSION_SUBSET queries of each
           row against the plain version, also with a row of no valid view
           and one of two real refs), row 5 at SA1 (8 x 32,768 -> 4,096,
           with the clusters the card holds at once) and rows 2-4 at every
           level, each timed beside its bound and yardstick;
       (d) config #4's training microbatch (B=2, N=102,400, V=8) with
           remat off and on, launching 1 / 1 / 3 / 4 / 4 a step.
     It prints the {"shapes": ...} line.
 10. runbook: python -m mvpnet_torch.runbook --smoke on a fake raw ScanNet
     tree (write_raw_scan, RAW_SCANS scans) in outputs/chip_smoke_runbook
     (removed after): every stage exits 0; each test_3d mode's forwards
     launch 1/4/0/4/4 (its log's launch line); the report has every key; a
     second invocation runs no stage; runs/scannet_smoke_*.json unchanged.
     Then each test_3d stage's command again in process on the runbook's
     checkpoint and preprocessed scans, through the kernels and with
     set_impl("reference"): the index ops (and the fused mode's
     knn_prepared) at the smoke shapes give equal outputs in the same
     order, and the two runs' mIoUs are printed. It prints the
     {"runbook": ...} line.
 11. e2e: mvpnet_torch.e2e_run's main in process (E2E_ARGS: a few steps of
     2D pretraining and of the warm-started fusion training at full width on
     two synthetic scenes, whole-scene evaluation of one held-out scene, the
     sharded estimator on the loopback mesh at space 2 beside the fused
     one): every results.json key, every mIoU in [0, 1], the 3D stage's
     launches the chunk path's a forward, every kernel of the whole-scene
     path launched, the sharded-against-fused agreement printed. It prints
     the {"e2e": ...} line.
Then it prints the {"kernels": [...]} line (seven kernels and the prep of
rows 6 and 7, "morton_prep": their launches, each row's launches on the
recipe's paths under "recipe_launches",
times and bounds on the scene path, the chunk path's under "chunk_path",
the train path's under "train_path", knn_prepared's under "fused_path";
rows 6 and 7 at the train shape, row 6's subgroup gate under "scene_path",
each row's launches on the dist phase's paths under "dist_launches", on
the e2e phase's stages under "e2e_launches", on the shapes and runbook
phases' paths under "shapes_launches"; rows 1-5 on config #3's train path
under "train32k_path"),
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
# /predict requests of the serve step, on example_batch seeds 0 to SERVE_REQUESTS - 1
SERVE_REQUESTS = 5
# the dist phase: steps of the launched and the in-process training runs, all
# in the deterministic mode (train.deterministic; cuBLAS needs
# CUBLAS_WORKSPACE_CONFIG, set before the first cuBLAS call); the largest
# relative difference of the launched run's step losses from the in-process
# run's after the first, which must be equal (one rank's DDP all-reduce is a
# copy); two in-process runs must be equal bit for bit. Two more in-process
# runs in the default mode show its spread (the backward's atomics sum in no
# fixed order, and Adam's first updates are lr * sign(g)), with no bound;
# seconds a launched command may take; the ring's space sizes and the
# sharded scene's
DIST_STEPS = 3
DIST_LOSS_RTOL = 1e-4
CUBLAS_WORKSPACE_CONFIG = ":4096:8"
DIST_TIMEOUT = 300
DIST_RING_SPACES = (2, 4)
DIST_SCENE_SPACE = 2
# (c)'s second, f32 comparison on the same weights
DIST_SCENE_F32 = ["model.unet.dtype=float32", "model.pn2.dtype=float32"]
# the e2e phase: e2e_run.main in process, a few steps of each stage at full
# width on a small synthetic corpus, validation cut to E2E_VAL_STEPS batches,
# whole-scene evaluation of one held-out scene
E2E_STEPS = 4
E2E_VAL_STEPS = 2
E2E_ARGS = ["--steps-2d", str(E2E_STEPS), "--steps-3d", str(E2E_STEPS), "--eval-scenes", "1", "--scenes", "2",
            "--objects", "6", "--seed", "0", f"train.val_steps={E2E_VAL_STEPS}"]
E2E_KEYS = {"val_2d_miou", "val_3d_miou", "whole_scene_single", "whole_scene_sharded", "steps_2d", "steps_3d",
            "devices", "eval_scenes", "seed", "zero_iou_classes", "absent_classes", "seconds", "launches"}
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
# the runbook phase: scans of the fake raw tree, each with its points and raw
# frames (data/preprocess.py keeps every 10th: 3 frames a scan)
RAW_SCANS = 3
RAW_POINTS = 6000
RAW_FRAMES = 30
RUNBOOK_TIMEOUT = 600
# the shapes phase: timed steps a variant after one untimed, and train_entry's;
# the parity gate of tests/test_parity.py: logits (and the loss) to an
# absolute PARITY_LOGITS_ABS with cosine > PARITY_LOGITS_COS, each gradient
# to cosine > PARITY_GRAD_COS with its norm within PARITY_GRAD_NORM
SHAPES_STEPS = 3
SHAPES_ENTRY_STEPS = 2
PARITY_LOGITS_ABS = 5e-3
PARITY_LOGITS_COS = 0.99999
PARITY_GRAD_COS = 0.999
PARITY_GRAD_NORM = 0.01


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def write_raw_scan(raw: str, scene_id: str, seed: int, points: int = RAW_POINTS, frames: int = RAW_FRAMES,
                   height: int = 60, width: int = 80) -> None:
    """One scan of a fake raw ScanNet tree in the layout data/preprocess.py
    reads (<raw>/scans/<id>/: the labelled binary PLY, color/<i>.jpg,
    depth/<i>.png in mm, label/<i>.png of NYU40 ids, pose/<i>.txt,
    intrinsic/intrinsic_depth.txt): a 3 m room's walls and floor, and frames
    from its middle looking out at the walls at 1.2-2.8 m. Needs PIL."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    scan = os.path.join(raw, "scans", scene_id)
    for d in ("color", "depth", "pose", "intrinsic", "label"):
        os.makedirs(os.path.join(scan, d), exist_ok=True)
    xyz = rng.uniform(0.0, 3.0, (points, 3)).astype(np.float32)
    side = rng.integers(0, 5, points)  # 4 walls and the floor
    for s, (axis, value) in enumerate([(0, 0.0), (0, 3.0), (1, 0.0), (1, 3.0), (2, 0.0)]):
        xyz[side == s, axis] = value
    xyz[:, 2] = np.where(side == 4, 0.0, xyz[:, 2] * (2.5 / 3.0))
    rgb = rng.integers(0, 256, (points, 3)).astype(np.uint8)
    nyu = np.where(side == 4, 2, rng.choice([1, 3, 5, 39], points)).astype(np.uint16)  # floor 2, walls 1 ...
    vertex = np.empty(points, np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("red", "u1"), ("green", "u1"),
                                        ("blue", "u1"), ("label", "<u2")]))
    for i, name in enumerate("xyz"):
        vertex[name] = xyz[:, i]
    for i, name in enumerate(("red", "green", "blue")):
        vertex[name] = rgb[:, i]
    vertex["label"] = nyu
    header = (f"ply\nformat binary_little_endian 1.0\nelement vertex {points}\n"
              "property float x\nproperty float y\nproperty float z\nproperty uchar red\nproperty uchar green\n"
              "property uchar blue\nproperty ushort label\nend_header\n")
    with open(os.path.join(scan, f"{scene_id}_vh_clean_2.labels.ply"), "wb") as f:
        f.write(header.encode("ascii") + vertex.tobytes())
    for fid in range(frames):
        theta = 2 * np.pi * fid / frames
        forward = np.array([np.cos(theta), np.sin(theta), 0.0])
        right = np.array([np.sin(theta), -np.cos(theta), 0.0])
        pose = np.eye(4)
        pose[:3, :3] = np.stack([right, [0.0, 0.0, -1.0], forward], axis=1)  # camera x right, y down, z forward
        pose[:3, 3] = [1.5, 1.5, 1.2]
        np.savetxt(os.path.join(scan, "pose", f"{fid}.txt"), pose)
        depth_mm = rng.uniform(1200, 2800, (height, width)).astype(np.uint16)
        Image.fromarray(rng.integers(0, 256, (height, width, 3)).astype(np.uint8)).save(
            os.path.join(scan, "color", f"{fid}.jpg"))
        Image.fromarray(depth_mm).save(os.path.join(scan, "depth", f"{fid}.png"))
        Image.fromarray(rng.choice([0, 1, 2, 3, 5], (height, width)).astype(np.uint8)).save(
            os.path.join(scan, "label", f"{fid}.png"))
    intr = np.eye(4)
    intr[0, 0] = intr[1, 1] = 0.6 * width
    intr[0, 2], intr[1, 2] = width / 2, height / 2
    np.savetxt(os.path.join(scan, "intrinsic", "intrinsic_depth.txt"), intr)


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


INDEX_OPS = ("knn", "farthest_point_sample", "ball_query", "three_nn_interpolate")


@contextlib.contextmanager
def recording(ops, names=INDEX_OPS):
    """Record the outputs of the public index ops while a request runs."""
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
    out["serve"] = serve_phase(torch, ops, d3, os.path.join(directory, "artifact"))

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


def http(url: str, body: bytes | None = None) -> tuple[int, bytes]:
    """(status, body) of a GET, or of a POST of ``body``, on the local server."""
    import urllib.error
    import urllib.request

    request = urllib.request.Request(url, data=body, method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(request, timeout=300) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def op_host_us(torch, reps: int = 500) -> dict:
    """Host microseconds a call of the brute three-NN takes through its
    public wrapper and op (``knn.knn`` -> ``torch.ops.mvpnet.knn``) and
    through its CUDA implementation alone (``knn.launch``), at a request's
    FP4 shape (64 queries over 16 refs, a launch far shorter than either):
    ``reps`` calls, one synchronize, in turns (op, launch, launch, op)."""
    from mvpnet_torch.ops import KERNELS

    brute = KERNELS["knn"]
    g = torch.Generator(device="cuda").manual_seed(0)
    q, r = (torch.rand((1, n, 3), generator=g, device="cuda") for n in (64, 16))
    calls = {"op": lambda: brute.knn(q, r, 3), "launch": lambda: brute.launch(q, r, 3)}
    times = {name: [] for name in calls}
    for name in ("op", "launch", "launch", "op"):
        calls[name]()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            calls[name]()
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) / reps * 1e6)
    return times


def serve_phase(torch, ops, run_dir: str, art: str) -> dict:
    """(d): the deployment path on the recipe's mvpnet_3d run (the training
    config, full width): cli.export_3d --batch-size 1 --check; the loaded
    program's mvpnet:: nodes (each kernel of the chunk path, as often as a
    request launches it, and no other); cli.serve_3d on port 0 in a thread:
    /healthz, /meta equal to meta.json, SERVE_REQUESTS /predict requests on
    example_batch seeds 0-4, each launching EXPECTED_LAUNCHES and meeting
    the --check rule against the restored model's eager forward, the first
    also against the plain versions' forward; junk gets 400 and /healthz
    still answers. Host ms of a /predict round trip and of the eager forward
    (the same batch's H2D copy, forward and D2H) in this process, and of the
    handler's work without the HTTP hop (npz decode, the artifact's forward,
    npz encode); the op layer's host cost a call (``op_host_us``)."""
    import io
    import threading

    from mvpnet_torch.cli import export_3d, serve_3d, test_3d
    from mvpnet_torch.config import load_config
    from mvpnet_torch.entry import TRAIN_CONFIG, example_batch, to_device
    from mvpnet_torch.eval.export_model import kernel_nodes, load_inference
    from mvpnet_torch.train.step import prepare_batch

    overrides = [*SYNTHETIC, f"output_dir={run_dir}"]
    cfg = load_config(TRAIN_CONFIG, overrides)
    try:
        check = export_3d.main(["--cfg", TRAIN_CONFIG, *overrides, "--out", art, "--batch-size", "1", "--check"])
    except SystemExit as e:
        fail(f"export_3d --check: {e}")
    size_mb = sum(os.path.getsize(os.path.join(art, f)) for f in os.listdir(art)) / 1e6
    print(f"  export_3d --check: {check['export_s']:.2f} s to export, artifact {size_mb:.1f} MB; argmax agreement "
          f"{check['agreement']} ({check['confident_agreement']} on margin > {export_3d.TAU}), max |delta| "
          f"{check['max_abs']}", flush=True)
    loaded = load_inference(art)
    nodes = kernel_nodes(loaded.program)
    want_nodes = {k: n for k, n in EXPECTED_LAUNCHES.items() if n}
    if nodes != want_nodes:
        fail(f"the loaded program's mvpnet:: nodes {nodes}, expected {want_nodes}")
    print(f"  loaded program: mvpnet:: nodes {nodes}", flush=True)

    model, _ = test_3d.restore(cfg, "cuda")
    with open(os.path.join(art, "meta.json")) as fh:
        meta = json.load(fh)
    spec = meta["input_spec"]
    B, N, _ = spec["points"]["shape"]
    _, V, H, W = spec["depth"]["shape"]

    def request_batch(seed):
        raw = example_batch(np.random.default_rng(seed), B=B, N=N, V=V, H=H, W=W)
        return {k: raw[k] for k in spec}

    @torch.no_grad()
    def eager(batch):
        return model(prepare_batch(cfg, to_device(batch, "cuda"), training=False))[0].float().cpu().numpy()

    def npz(**arrays) -> bytes:
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        return buf.getvalue()

    httpd = serve_3d.serve(art, port=0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        if http(f"{base}/healthz") != (200, b"ok"):
            fail(f"/healthz: {http(f'{base}/healthz')}")
        status, body = http(f"{base}/meta")
        if status != 200 or json.loads(body) != meta:
            fail(f"/meta: status {status}, equal to meta.json: {status == 200 and json.loads(body) == meta}")
        http(f"{base}/predict", npz(**request_batch(SERVE_REQUESTS)))  # warm-up
        eager(request_batch(SERVE_REQUESTS))
        requests = []
        for seed in range(SERVE_REQUESTS):
            batch = request_batch(seed)
            body = npz(**batch)
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            status, reply = http(f"{base}/predict", body)
            predict_ms = (time.perf_counter() - t0) * 1e3
            counts = ops.launch_counts()
            if status != 200:
                fail(f"/predict {seed}: status {status}: {reply[:300]!r}")
            if counts != EXPECTED_LAUNCHES:
                fail(f"/predict {seed}: kernel launches {counts}, expected {EXPECTED_LAUNCHES}")
            with np.load(io.BytesIO(reply)) as z:
                logits = z["logits"]
            t0 = time.perf_counter()
            want = eager(batch)
            eager_ms = (time.perf_counter() - t0) * 1e3
            if logits.shape != tuple(meta["output"]["shape"]) or not np.isfinite(logits).all():
                fail(f"/predict {seed}: logits {logits.shape}, finite={bool(np.isfinite(logits).all())}")
            result = export_3d.agreement(logits, want)
            if result["confident_agreement"] < export_3d.MIN_CONFIDENT_AGREEMENT:
                fail(f"/predict {seed}: the artifact against the eager forward {result}")
            requests.append(dict(result, seed=seed, predict_ms=predict_ms, eager_ms=eager_ms))
            print(f"  /predict {seed}: {predict_ms:.3f} ms (eager forward {eager_ms:.3f} ms), launches as a request, "
                  f"argmax agreement {result['agreement']} with the eager forward, max |delta| {result['max_abs']}",
                  flush=True)
        # where a round trip's time goes: the handler's work in this process
        # (decode the npz, the artifact's forward, the logits to the host,
        # encode the reply), and the artifact's forward alone
        for r in requests:
            body = npz(**request_batch(r["seed"]))
            t0 = time.perf_counter()
            with np.load(io.BytesIO(body)) as z:
                logits = loaded({k: z[k] for k in z.files}).float().cpu().numpy()
            t1 = time.perf_counter()
            npz(logits=logits)
            r["handler_ms"] = (time.perf_counter() - t0) * 1e3
            r["artifact_forward_ms"] = (t1 - t0) * 1e3
        batch = request_batch(0)
        ops.set_impl("reference")
        try:
            ops.reset_launch_counts()
            plain = eager(batch)
            if any(ops.launch_counts().values()):
                fail(f"the reference forward launched kernels: {ops.launch_counts()}")
        finally:
            ops.set_impl("auto")
        status, reply = http(f"{base}/predict", npz(**batch))
        with np.load(io.BytesIO(reply)) as z:
            reference_agreement = float((z["logits"].argmax(-1) == plain.argmax(-1)).mean())
        print(f"  /predict 0 against the plain versions' eager forward: argmax agreement {reference_agreement}",
              flush=True)
        status, reply = http(f"{base}/predict", b"junk")
        if status != 400 or "error" not in json.loads(reply):
            fail(f"a junk /predict: status {status}, {reply[:300]!r}")
        if http(f"{base}/healthz")[0] != 200:
            fail("/healthz after a junk request")
        print("  junk /predict: 400 with an error; /healthz 200 after it", flush=True)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    host_us = op_host_us(torch)
    print(f"  the op layer: {host_us['op']} us a call of the three-NN's wrapper through torch.ops.mvpnet.knn, "
          f"{host_us['launch']} us of its CUDA implementation alone (host time, FP4's shape)", flush=True)
    predict = [r["predict_ms"] for r in requests]
    eager_ms = [r["eager_ms"] for r in requests]
    summary = {
        "card": card_line(), "export_s": check["export_s"], "artifact_mb": size_mb, "check": check,
        "program_nodes": nodes, "requests": requests, "predict_ms_median": statistics.median(predict),
        "predict_ms_max": max(predict), "eager_ms_median": statistics.median(eager_ms),
        "handler_ms_median": statistics.median(r["handler_ms"] for r in requests),
        "artifact_forward_ms_median": statistics.median(r["artifact_forward_ms"] for r in requests),
        "max_abs": max(r["max_abs"] for r in requests), "reference_argmax_agreement": reference_agreement,
        "op_host_us": host_us,
    }
    print(f"  serve: /predict median {summary['predict_ms_median']:.3f} ms, max {summary['predict_ms_max']:.3f} ms; "
          f"eager forward median {summary['eager_ms_median']:.3f} ms; in this process the handler's work "
          f"{summary['handler_ms_median']:.3f} ms, of which the artifact's forward (decode included) "
          f"{summary['artifact_forward_ms_median']:.3f} ms; max |delta| {summary['max_abs']} "
          f"({summary['card']})", flush=True)
    return summary


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


def read_losses(run_dir: str) -> list[float]:
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [r["train/loss"] for r in map(json.loads, f) if "train/loss" in r]


def launch(cmd: list) -> subprocess.Popen:
    """Start a command line under torch.distributed.run, one rank on this
    card (its output in temporary files, read by ``finish``), with the cuBLAS
    workspace that the deterministic mode needs."""
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1", *cmd]
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=CUBLAS_WORKSPACE_CONFIG)
    # a session of its own, so that ``stop`` can kill what the launcher leaves
    proc = subprocess.Popen(argv, stdout=out, stderr=err, text=True, cwd=root, env=env, start_new_session=True)
    proc.files = (out, err)
    return proc


def stop(proc: subprocess.Popen) -> None:
    """End a ``launch``ed command that is still running, with its ranks: the
    launcher stops its ranks on SIGTERM (they run in sessions of their own);
    past 30 s the launcher's session is killed."""
    import signal

    if proc.poll() is not None:
        return
    proc.terminate()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def finish(proc: subprocess.Popen, what: str, timeout: int = DIST_TIMEOUT) -> str:
    """Wait for a ``launch``ed command (killed past ``timeout``); its stdout,
    or fail with the end of its stderr."""
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        stop(proc)
        fail(f"{what} under torch.distributed.run did not finish in {timeout} s")
    out, err = proc.files
    out.seek(0)
    err.seek(0)
    stdout, stderr = out.read(), err.read()
    out.close()
    err.close()
    if proc.returncode:
        fail(f"{what} under torch.distributed.run exited {proc.returncode}: {stderr[-3000:]}")
    return stdout


def log_span_s(text: str) -> float:
    """Seconds between the first and the last timestamped log line."""
    import datetime
    import re

    stamps = re.findall(r"^(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3}) ", text, re.M)
    parse = [datetime.datetime.strptime(t, "%Y-%m-%d %H:%M:%S,%f") for t in stamps]
    return (parse[-1] - parse[0]).total_seconds() if parse else 0.0


def dist_launcher_runs(torch, ops, directory: str) -> dict:
    """(a): cli.train_3d under the launcher (NCCL, world 1) against two
    in-process train() runs of the same config, all in the deterministic
    mode, beside two in-process runs in the default mode; then cli.test_3d
    --sharded under the launcher."""
    import ast
    import re

    from mvpnet_torch.config import load_config
    from mvpnet_torch.entry import TRAIN_CONFIG
    from mvpnet_torch.train.loop import set_deterministic, train

    over = SYNTHETIC + [f"train.max_steps={DIST_STEPS}", "train.log_every=1", "train.val_steps=1",
                        "data.num_workers=1", "model.pretrained_2d=", "mesh.data=1"]
    run = os.path.join(directory, "launched")
    t0 = time.perf_counter()
    proc = launch(["-m", "mvpnet_torch.cli.train_3d", "--cfg", TRAIN_CONFIG, *over, "train.deterministic=true",
                   f"output_dir={run}"])
    runs, out = {}, {}
    try:
        # meanwhile the in-process run, twice in each mode: the deterministic
        # mode's repeat and the default mode's spread
        for mode in ("deterministic", "default"):
            for i in range(2):
                local = os.path.join(directory, f"in_process_{mode}_{i}")
                cfg = load_config(TRAIN_CONFIG, over + [f"train.deterministic={mode == 'deterministic'}",
                                                        f"output_dir={local}"])
                t1 = time.perf_counter()
                try:
                    train(cfg, device="cuda")
                finally:
                    set_deterministic(False)
                out[f"in_process_{mode}_{i}_s"] = time.perf_counter() - t1
                runs.setdefault(mode, []).append(read_losses(local))
        finish(proc, "cli.train_3d")
    finally:
        stop(proc)  # still running only when the in-process runs failed
    out["train_3d_s"] = time.perf_counter() - t0
    with open(os.path.join(run, "log.txt")) as f:
        log = f.read()
    out["train_3d_log_s"] = log_span_s(log)
    line = "distributed: backend nccl, rank 0, world 1, device cuda:0"
    if line not in log:
        fail(f"cli.train_3d under the launcher did not log {line!r}")
    found = re.search(r"kernel launches since start: (\{.*\})", log)
    counts = ast.literal_eval(found.group(1))
    forwards = DIST_STEPS + 1  # the steps and one validation batch
    out["launches_per_step"] = {k: v / forwards for k, v in counts.items()}
    if counts != {k: n * forwards for k, n in TRAIN_LAUNCHES.items()}:
        fail(f"cli.train_3d under the launcher: launches {counts}, want {TRAIN_LAUNCHES} x {forwards}")
    got = read_losses(run)
    det, default = runs["deterministic"], runs["default"]
    if len(got) != DIST_STEPS or any(len(r) != DIST_STEPS for r in det + default) or not all(map(np.isfinite, got)):
        fail(f"step losses: launched {got}, in process {runs}")

    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    out.update(losses=got, in_process_losses=det, default_mode_losses=default, max_rel_loss_delta=rel(got, det[0]),
               in_process_equal=det[0] == det[1], default_mode_spread=rel(default[1], default[0]),
               first_step_equal=got[0] == det[0][0])
    print(f"  (a) deterministic mode, NCCL world 1: losses {got} against {det[0]} in process: first step "
          f"{'equal' if out['first_step_equal'] else 'differs'}, max rel {out['max_rel_loss_delta']:.2e}; two "
          f"in-process runs {'equal bit for bit' if out['in_process_equal'] else f'differ: {det[1]}'}; default "
          f"mode's two in-process runs {default[0]} and {default[1]}: spread {out['default_mode_spread']:.2e}; "
          f"launches a step {out['launches_per_step']}", flush=True)
    if not out["in_process_equal"]:
        fail(f"deterministic mode: two in-process runs gave {det[0]} and {det[1]}")
    if not out["first_step_equal"] or out["max_rel_loss_delta"] > DIST_LOSS_RTOL:
        fail(f"launched losses {got} differ from the in-process run's {det[0]} beyond the first step's equality "
             f"or {DIST_LOSS_RTOL}")

    t0 = time.perf_counter()
    stdout = finish(launch(["-m", "mvpnet_torch.cli.test_3d", "--cfg", TRAIN_CONFIG, "--sharded", *SYNTHETIC,
                            "mesh.space=1", f"output_dir={run}"]), "cli.test_3d --sharded")
    out["test_3d_sharded_s"] = time.perf_counter() - t0
    out["test_3d_sharded_log_s"] = log_span_s(stdout)
    results = json.loads(stdout.strip().splitlines()[-1])
    if "sharded whole-scene eval over mesh {'data': 1, 'space': 1} (distributed: backend nccl" not in stdout:
        fail("cli.test_3d --sharded did not run the sharded estimator over NCCL")
    if not 0.0 <= results["miou"] <= 1.0:
        fail(f"cli.test_3d --sharded mIoU {results['miou']}")
    out["test_3d_sharded_miou"] = results["miou"]
    print(f"  (a) cli.train_3d {out['train_3d_s']:.1f} s ({out['train_3d_log_s']:.1f} s logged); cli.test_3d "
          f"--sharded (space=1): mIoU {results['miou']:.4f} in {out['test_3d_sharded_s']:.1f} s "
          f"({out['test_3d_sharded_log_s']:.1f} s logged)", flush=True)
    return out


def scatter_ms(torch, ops) -> dict:
    """(a): the sums whose order the deterministic mode fixes (a sorted
    path in place of atomics), timed with CUDA events: index_add_ of the
    kNN backward at the train shape (8 x 8192 x 3 rows of 3 into 8 x
    57,600) and of the scene's logit accumulation (4 windows of 8192
    points, 20 logits, into 300,000 points), and group_points forward and
    backward at the fusion gather (8 x 8192 x 3 picks of 64 bf16 features
    out of 8 x 57,600 pixels)."""
    g = torch.Generator(device="cuda").manual_seed(0)

    def index_add(rows: int, width: int, n: int):
        idx = torch.randint(0, n, (rows,), generator=g, device="cuda")
        src = torch.randn(rows, width, generator=g, device="cuda")
        acc = torch.zeros(n, width, device="cuda")
        return cuda_ms(torch, lambda: acc.index_add_(0, idx, src), KERNEL_REPS)

    feat = torch.randn(8, 57600, 64, generator=g, device="cuda").bfloat16().requires_grad_()
    idx = torch.randint(0, 57600, (8, 8192, 3), generator=g, device="cuda")
    grad = torch.randn(8, 8192, 3, 64, generator=g, device="cuda").bfloat16()
    return {"index_add_knn_backward": index_add(8 * 8192 * 3, 3, 8 * 57600),
            "index_add_scene_accumulation": index_add(4 * 8192, 20, 300_000),
            "group_points_forward_backward": cuda_ms(
                torch, lambda: torch.autograd.grad(ops.group_points(feat, idx), feat, grad), KERNEL_REPS)}


def mode_step_ms(torch, ops) -> dict:
    """(a): train_entry's step at the training config, TRAIN_STEPS steps in
    the default mode, then TRAIN_STEPS more in the deterministic mode, on
    one model: each mode's median step ms (its first step left out), and
    ``scatter_ms`` in each mode."""
    from mvpnet_torch.entry import train_entry
    from mvpnet_torch.train.loop import set_deterministic

    step, (model, optimizer, batches) = train_entry(seed=0)
    out, scatters = {}, {}
    try:
        out["default"] = train_steps(torch, ops, step, batches, model, optimizer, 1, label="default mode")
        scatters["default"] = scatter_ms(torch, ops)
        set_deterministic(device="cuda")
        try:
            out["deterministic"] = train_steps(torch, ops, step, batches, model, optimizer, 1,
                                               label="deterministic mode")
            scatters["deterministic"] = scatter_ms(torch, ops)
        finally:
            set_deterministic(False)
    finally:
        batches.close()
    ms = {mode: statistics.median(r["step_ms"][1:]) for mode, r in out.items()}
    print(f"  (a) train step ms median: default mode {ms['default']:.2f}, deterministic mode "
          f"{ms['deterministic']:.2f} ({ms['deterministic'] / ms['default']:.2f}x); scatters ms (default, "
          f"deterministic): " + ", ".join(f"{k} {scatters['default'][k]:.4f}, {scatters['deterministic'][k]:.4f}"
                                          for k in scatters["default"]), flush=True)
    return {"step_ms_median": ms, "step_ms": {mode: r["step_ms"] for mode, r in out.items()},
            "peak_memory_gib": {mode: r["peak_memory_gib"] for mode, r in out.items()}, "scatter_ms": scatters}


def scene_cloud(torch, cfg, scene):
    """The scene view set's pixel cloud on the card (views of 120x160 in
    order, so a space shard's block is a run of whole views) and a pass of
    windows: chunks_per_shard a shard for ``space`` shards."""
    from mvpnet_torch.core.camera import unproject_views
    from mvpnet_torch.eval.sharded_scene import enumerate_scene_chunks, select_scene_views

    frames = select_scene_views(scene, cfg.eval.scene_views)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()

    xyz, _ = unproject_views(put(scene.depth[frames]), put(scene.intrinsics), put(scene.poses[frames]))
    return xyz.reshape(-1, 3), [put(c[1]) for c in enumerate_scene_chunks(scene, cfg)]


def ring_case(torch, ops, cfg, scene, S: int) -> dict:
    """(b): the ring on the loopback mesh at ``space`` S over the scene's
    pixel cloud, each pixel's feature its index: S^2 launches of row 1, d
    and the picks equal to the unsharded search bit for bit; a hop, the
    unsharded search of the same queries and a whole pass timed."""
    from mvpnet_torch.dist.fusion import ring_knn_local
    from mvpnet_torch.dist.mesh import make_mesh

    mesh = make_mesh(local=S)
    k = cfg.model.aggregation.k
    cloud, windows = scene_cloud(torch, cfg, scene)
    per = cfg.eval.chunks_per_shard
    windows = (windows * (per * S))[: per * S]  # one pass, the scene's windows repeated to fill it
    pts = [torch.cat(windows[s * per : (s + 1) * per]) for s in range(S)]
    blocks = list(cloud.chunk(S))
    index = torch.arange(len(cloud), device="cuda", dtype=torch.float32)[:, None]
    feats = list(index.chunk(S))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    out = ring_knn_local(pts, blocks, feats, k=k, mesh=mesh)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    want = dict.fromkeys(launches, 0) | {"knn_fusion": S * S}
    if launches != want:
        fail(f"ring at space {S}: launches {launches}, want {want}")
    for s, (d, _, picked) in enumerate(out):
        d_all, idx_all = ops.knn(pts[s][None], cloud[None], k)
        if not torch.equal(d, d_all[0]) or not torch.equal(picked[..., 0].long(), idx_all[0].long()):
            n = int((picked[..., 0].long() != idx_all[0].long()).sum())
            fail(f"ring at space {S}, shard {s}: not bit-equal to the unsharded kNN ({n} picks differ)")
    hop = cuda_ms(torch, lambda: ops.knn(pts[0][None], blocks[0][None], k), KERNEL_REPS)
    whole = cuda_ms(torch, lambda: ops.knn(pts[0][None], cloud[None], k), KERNEL_REPS)
    ring_pass = cuda_ms(torch, lambda: ring_knn_local(pts, blocks, feats, k=k, mesh=mesh), PLAIN_REPS)
    unsharded_pass = cuda_ms(torch, lambda: [ops.knn(p[None], cloud[None], k) for p in pts], PLAIN_REPS)
    row = {"space": S, "queries_a_shard": len(pts[0]), "refs": len(cloud), "block_refs": len(blocks[0]),
           "launches": launches["knn_fusion"], "hop_ms": hop, "unsharded_ms": whole, "pass_ms": ring_pass,
           "unsharded_pass_ms": unsharded_pass}
    print(f"  (b) ring space {S}: {len(pts[0])} queries x {len(blocks[0])} refs a hop {hop:.4f} ms, "
          f"x {len(cloud)} refs unsharded {whole:.4f} ms; pass {ring_pass:.3f} ms (S^2 = {S * S} launches of "
          f"row 1, d and picks equal) against {unsharded_pass:.3f} ms unsharded", flush=True)
    return row


def sharded_scene_case(torch, ops, cfg, scene) -> dict:
    """(c): predict_scene_sharded on the loopback mesh at DIST_SCENE_SPACE
    with the launched run's weights against predict_scene_fused on the
    same scene: its launches and ms a pass and both estimators' agreement
    in the config's bf16, held to cli.export_3d's margin rule with a tie
    band that scales with the logits (bf16_tie_band: BF16_TIE_STEPS bf16
    grid steps at the top logit, at least TAU; on 3-step weights eval-mode
    logits reach 1e3-1e5, where the grid step exceeds TAU); then both again
    in f32 (DIST_SCENE_F32) on the same weights, held to the rule with TAU.
    The largest relative top-2 margin of the points where the two differ
    in bf16 is printed beside them."""
    from mvpnet_torch.cli.export_3d import BF16_TIE_STEPS, MIN_CONFIDENT_AGREEMENT, TAU, agreement, bf16_tie_band
    from mvpnet_torch.cli.test_3d import restore
    from mvpnet_torch.config import load_config
    from mvpnet_torch.dist.mesh import make_mesh
    from mvpnet_torch.entry import TRAIN_CONFIG
    from mvpnet_torch.eval.scene_fused import build_scene_fused_fns, predict_scene_fused
    from mvpnet_torch.eval.sharded_scene import build_sharded_scene_fns, enumerate_scene_chunks, predict_scene_sharded

    S = DIST_SCENE_SPACE
    mesh = make_mesh(local=S)

    def both(cfg, timed: bool, bf16: bool):
        model, _ = restore(cfg, "cuda")
        fns, fused_fns = build_sharded_scene_fns(model, cfg, mesh), build_scene_fused_fns(model, cfg)
        if timed:
            predict_scene_sharded(model, cfg, scene, mesh, fns=fns)  # warm-up
            predict_scene_fused(model, cfg, scene, fns=fused_fns)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        got = predict_scene_sharded(model, cfg, scene, mesh, fns=fns)
        torch.cuda.synchronize()
        sharded_s = time.perf_counter() - t0
        launches = ops.launch_counts()
        t0 = time.perf_counter()
        want = predict_scene_fused(model, cfg, scene, fns=fused_fns)
        fused_s = time.perf_counter() - t0
        if not np.isfinite(got).all():
            fail("predict_scene_sharded: non-finite logits")
        top = np.sort(want, axis=-1)
        differ = got.argmax(-1) != want.argmax(-1)
        margin = (top[:, -1] - top[:, -2]) / np.maximum(np.abs(top[:, -1]), 1e-6)
        agree = agreement(got[None], want[None], tau=bf16_tie_band(want[None]) if bf16 else TAU)
        agree["differ_max_rel_margin"] = float(margin[differ].max()) if differ.any() else 0.0
        agree["median_abs_logit"] = float(np.median(np.abs(want)))
        return agree, launches, sharded_s, fused_s

    agree, launches, sharded_s, fused_s = both(cfg, timed=True, bf16=True)
    passes = -(-len(enumerate_scene_chunks(scene, cfg)) // (cfg.eval.chunks_per_shard * S))
    per_pass = dict.fromkeys(launches, 0) | {"knn_fusion": S * S, "fps": 4 * S, "ball_query": 4 * S, "knn": 4 * S}
    if launches != {k: n * passes for k, n in per_pass.items()}:
        fail(f"predict_scene_sharded: launches {launches}, want {per_pass} x {passes} passes")
    agree32 = both(load_config(TRAIN_CONFIG, SYNTHETIC + DIST_SCENE_F32 + [f"output_dir={cfg.output_dir}"]),
                   timed=False, bf16=False)[0]
    out = {"space": S, "points": len(scene.points), "passes": passes, "launches_per_pass": per_pass,
           "ms_a_pass": 1e3 * sharded_s / passes, "sharded_s": sharded_s, "fused_s": fused_s, **agree, "f32": agree32}
    print(f"  (c) predict_scene_sharded, space {S}: {passes} passes of {cfg.eval.chunks_per_shard * S} windows, "
          f"{out['ms_a_pass']:.1f} ms a pass ({sharded_s:.3f} s; fused {fused_s:.3f} s); launches a pass {per_pass}; "
          f"against the fused estimator in bf16: argmax {agree['agreement']:.5f}, {agree['confident_agreement']:.5f} "
          f"on the {agree['confident_share']:.5f} of decisions beyond {BF16_TIE_STEPS} bf16 steps, max |delta| "
          f"{agree['max_abs']:.3e} on logits of median |{agree['median_abs_logit']:.0f}|"
          f", the points that differ within {agree['differ_max_rel_margin']:.4f} of their top logit; in f32: argmax "
          f"{agree32['agreement']:.5f}, {agree32['confident_agreement']:.5f} on margin decisions, max |delta| "
          f"{agree32['max_abs']:.3e}", flush=True)
    if agree["confident_agreement"] < MIN_CONFIDENT_AGREEMENT:
        fail(f"sharded scene disagrees with the fused estimator beyond the bf16 tie band: {agree}")
    if agree32["confident_agreement"] < MIN_CONFIDENT_AGREEMENT:
        fail(f"sharded scene disagrees with the fused estimator beyond the margin rule in f32: {agree32}")
    return out


def dist_phase(torch) -> dict:
    """8: the multi-device layer on one card: (a) NCCL at world size 1
    through the launcher, (b) the ring on the loopback mesh at space 2 and
    4, (c) the space-sharded scene estimator on the loopback mesh."""
    import shutil

    from mvpnet_torch import ops
    from mvpnet_torch.config import load_config
    from mvpnet_torch.data.pipeline import build_dataset
    from mvpnet_torch.entry import TRAIN_CONFIG

    t0 = time.perf_counter()
    directory = os.path.join(os.path.dirname(os.path.abspath(__file__)), "outputs", "chip_smoke_dist")
    shutil.rmtree(directory, ignore_errors=True)
    try:
        summary = {"nccl_world1": dist_launcher_runs(torch, ops, directory), "modes": mode_step_ms(torch, ops)}
        cfg = load_config(TRAIN_CONFIG, SYNTHETIC + [f"output_dir={directory}/launched"])
        scene = build_dataset(cfg.data, batch_size=1, training=False, seed=0).scenes[0]
        with torch.no_grad():
            summary["ring"] = [ring_case(torch, ops, cfg, scene, S) for S in DIST_RING_SPACES]
            summary["sharded_scene"] = sharded_scene_case(torch, ops, cfg, scene)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    summary["seconds"] = time.perf_counter() - t0
    print(f"  dist phase: {summary['seconds']:.1f} s", flush=True)
    return summary


def e2e_phase(torch) -> dict:
    """11: mvpnet_torch.e2e_run's main in process (2D pretraining, the warm
    started fusion training, whole-scene evaluation, the sharded estimator
    against the fused one), E2E_ARGS: every results.json key, every mIoU in
    [0, 1], no launch in the 2D stage, the chunk path's launches a forward
    of the 3D stage (its steps and validation batches), every kernel of the
    whole-scene path launched; the launch counts set to 0 just before."""
    import shutil

    from mvpnet_torch import e2e_run, ops

    t0 = time.perf_counter()
    directory = os.path.join(os.path.dirname(os.path.abspath(__file__)), "outputs", "chip_smoke_e2e")
    shutil.rmtree(directory, ignore_errors=True)
    try:
        ops.reset_launch_counts()
        results = e2e_run.main(["--out", directory, *E2E_ARGS])
        total = ops.launch_counts()
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    if set(results) != E2E_KEYS:
        fail(f"e2e_run results.json keys {sorted(results)}, want {sorted(E2E_KEYS)}")
    single, sharded = results["whole_scene_single"], results["whole_scene_sharded"]
    mious = [results["val_2d_miou"], results["val_3d_miou"], single["miou"], sharded["miou_sharded"],
             sharded["miou_fused"]]
    if not all(0.0 <= m <= 1.0 for m in mious):
        fail(f"e2e_run mIoUs {mious}")
    launches = results["launches"]
    every = {k: sum(stage[k] for stage in launches.values()) for k in total}
    if every != total:
        fail(f"e2e_run stages' launches {launches} do not add up to the run's {total}")
    if any(launches["train_2d"].values()):
        fail(f"e2e_run 2D stage launched kernels: {launches['train_2d']}")
    every_val = max(E2E_STEPS // 2, 1)  # e2e_run's train.val_every of the 3D stage
    vals = sum(1 for s in range(1, E2E_STEPS + 1) if s % every_val == 0 or s == E2E_STEPS)
    forwards = E2E_STEPS + vals * E2E_VAL_STEPS
    if launches["train_3d"] != {k: n * forwards for k, n in TRAIN_LAUNCHES.items()}:
        fail(f"e2e_run 3D stage: launches {launches['train_3d']}, want {TRAIN_LAUNCHES} x {forwards} forwards")
    for stage in ("whole_scene", "whole_scene_sharded"):
        if not all(launches[stage][k] for k in ("knn_fusion", "fps", "ball_query", "knn")):
            fail(f"e2e_run {stage}: launches {launches[stage]}")
    seconds = time.perf_counter() - t0
    print(f"  e2e_run: 2D val mIoU {results['val_2d_miou']:.4f}, 3D val mIoU {results['val_3d_miou']:.4f}, "
          f"whole-scene mIoU {single['miou']:.4f} ({results['zero_iou_classes']} classes at zero IoU); sharded "
          f"against fused (space {sharded['space']}): argmax agreement {sharded['agreement']:.6f} over "
          f"{sharded['points']} points, mIoU {sharded['miou_sharded']:.4f} / {sharded['miou_fused']:.4f}; launches "
          f"a 3D step {TRAIN_LAUNCHES} ({forwards} forwards), stages {launches}; stage seconds "
          f"{ {k: round(v, 1) for k, v in results['seconds'].items()} }; phase {seconds:.1f} s", flush=True)
    return {"results": results, "forwards_3d": forwards, "seconds": seconds}


def e2e_launches(summary: dict, name: str) -> dict:
    """A kernel's launches in each stage of the e2e phase, and a 3D step's."""
    stages = summary["results"]["launches"]
    return {**{stage: counts[name] for stage, counts in stages.items()},
            "train_3d_step": stages["train_3d"][name] / summary["forwards_3d"]}


def close(torch, what: str, got, want, tol: float, cos_min: float) -> dict:
    """Hold ``got`` to ``want``: max |got - want| < tol and cosine >
    cos_min; returns both."""
    a, b = got.detach().double().flatten(), want.detach().double().flatten()
    err = (a - b).abs().max().item()
    cos = (a @ b / (a.norm() * b.norm())).item() if a.norm() > 0 and b.norm() > 0 else float(torch.equal(a, b))
    if not err < tol or not cos > cos_min:
        fail(f"{what}: max |delta| {err} (limit {tol}), cosine {cos} (limit {cos_min})")
    return {"max_abs_err": err, "cosine": cos}


def microbatch_run(torch, ops, cfg, model, init_state, mb, loss_fn, impl: str) -> dict:
    """One microbatch's forward and backward from ``init_state`` through
    ``impl``'s ops: the loss, the 3D logits, every gradient, the index ops'
    outputs and the launches (counts set to 0 just before)."""
    from mvpnet_torch.models.blocks import Dropout
    from mvpnet_torch.train.step import prepare_batch

    model.load_state_dict(init_state)
    model.zero_grad(set_to_none=True)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = None
    ops.set_impl(impl)
    try:
        ops.reset_launch_counts()
        with recording(ops) as log:
            batch = prepare_batch(cfg, mb, training=True, generator=torch.Generator().manual_seed(0))
            out = model(batch)
            loss = loss_fn(out, batch)
            loss.backward()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    finally:
        ops.set_impl("auto")
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters() if p.grad is not None}
    return {"loss": loss.detach(), "logits": out[0].detach(), "grads": grads, "log": log, "launches": counts}


def microbatch_parity(torch, ops, cfg, batch, label: str) -> dict:
    """The first microbatch of ``batch`` at ``cfg`` (train.remat as set),
    forward and backward from seeded weights in the deterministic mode (the
    default mode's atomics sum the bf16 backward in another order each run,
    which moves a BatchNorm scale's gradient by ~1%), through the kernels
    (``config_shapes.expected_launches``) and through the plain versions
    (none): equal index-op outputs; loss and logits within PARITY_LOGITS_ABS
    and PARITY_LOGITS_COS, every gradient within PARITY_GRAD_COS and
    PARITY_GRAD_NORM (tests/test_parity.py's gate)."""
    from mvpnet_torch.config_shapes import expected_launches
    from mvpnet_torch.models.build import build_model, loss_and_metrics
    from mvpnet_torch.ops import fps
    from mvpnet_torch.train.loop import set_deterministic, set_train_mode

    rows = cfg.train.batch_size // max(1, cfg.train.grad_accum)
    mb = {k: v[:rows] for k, v in batch.items()}
    model, _, _ = build_model(cfg, seed=0)
    model = model.to("cuda")
    set_train_mode(model, cfg)
    init_state = {k: v.clone() for k, v in model.state_dict().items()}
    loss_fn = loss_and_metrics(cfg)[0]
    set_deterministic(device="cuda")  # the backward's sums in one order, run to run
    try:
        got = microbatch_run(torch, ops, cfg, model, init_state, mb, loss_fn, "auto")
        want = microbatch_run(torch, ops, cfg, model, init_state, mb, loss_fn, "reference")
    finally:
        set_deterministic(False)
    launches = expected_launches(cfg, fps.shared_bytes(torch.device("cuda")))
    if got["launches"] != launches or any(want["launches"].values()):
        fail(f"{label} microbatch: launches {got['launches']} through the kernels (want {launches}), "
             f"{want['launches']} through the plain versions")
    n_equal = compare_logs(torch, got["log"], want["log"], f"{label} microbatch")
    loss = close(torch, f"{label} loss", got["loss"], want["loss"], PARITY_LOGITS_ABS, -1.0)
    logits = close(torch, f"{label} logits", got["logits"], want["logits"], PARITY_LOGITS_ABS, PARITY_LOGITS_COS)
    if set(got["grads"]) != set(want["grads"]):
        fail(f"{label}: gradients of other parameters through the kernels and the plain versions")
    worst_cos, worst_ratio = 1.0, 1.0
    for name, g in got["grads"].items():
        w = want["grads"][name]
        gn, wn = g.double().norm().item(), w.double().norm().item()
        if gn == wn == 0.0:
            continue
        ratio = gn / wn if wn > 0 else float("inf")
        cos = (g.double().flatten() @ w.double().flatten()).item() / (gn * wn) if gn * wn > 0 else 0.0
        if not cos > PARITY_GRAD_COS or not abs(ratio - 1.0) < PARITY_GRAD_NORM:
            fail(f"{label} gradient {name}: cosine {cos}, norm ratio {ratio}")
        worst_cos, worst_ratio = min(worst_cos, cos), max(worst_ratio, abs(ratio - 1.0) + 1.0)
    print(f"  {label} first microbatch ({rows} chunks) through the plain versions: {n_equal} index-op outputs "
          f"equal, loss {got['loss'].item():.6f} / {want['loss'].item():.6f}, logits max |delta| "
          f"{logits['max_abs_err']:.3g} cosine {logits['cosine']:.8f}, {len(got['grads'])} gradients: worst "
          f"cosine {worst_cos:.6f}, worst norm ratio {worst_ratio:.6f}; launches {got['launches']}", flush=True)
    del model
    torch.cuda.empty_cache()
    return {"rows": rows, "index_op_outputs_equal": n_equal, "loss": loss, "logits": logits,
            "gradients": len(got["grads"]), "worst_grad_cosine": worst_cos, "worst_grad_norm_ratio": worst_ratio,
            "launches": got["launches"]}


def train32k_rows(torch, cfg, batch) -> dict:
    """Rows 1-5 on the first microbatch of a train_entry batch at config #3
    (its chunks drawn with replacement where a chunk holds fewer points:
    exact duplicates), augmented as the step does: row 1 in its route's
    (demand) mode on the batch's own pixel cloud, held on FUSION_SUBSET
    queries a row, and with a row whose views are all invalid and a row of
    two real refs (fewer than k: ties to the lower index); row 5 at SA1;
    rows 2-4 at every level. Returns {kernel: row}."""
    from mvpnet_torch.ops import KERNELS, reference
    from mvpnet_torch.train.step import prepare_batch

    fusion, fps = KERNELS["knn_fusion"], KERNELS["fps"]
    rows = cfg.train.batch_size // max(1, cfg.train.grad_accum)
    with torch.no_grad():
        mb = prepare_batch(cfg, {k: v[:rows] for k, v in batch.items()}, training=True,
                           generator=torch.Generator().manual_seed(0))
        pts = mb["points"].float().contiguous()
        pix = mb["image_xyz"].reshape(pts.shape[0], -1, 3).contiguous()
        del mb
        k = cfg.model.aggregation.k
        B, M, N = pts.shape[0], pts.shape[1], pix.shape[1]
        dup = 1.0 - sum(torch.unique(row, dim=0).shape[0] for row in pts) / (B * M)
        print(f"  config #3 fusion inputs: {B}x{M} points ({dup:.4f} of them repeat a point of their row), "
              f"{N} pixels a row, {(pix.abs() >= 1e5).any(-1).float().mean().item():.4f} of them "
              f"sentinels; route {fusion.route(B, M, N)}", flush=True)
        few = pix.clone()
        few[0] = 1e6  # every view of the row invalid
        few[1] = 1e6
        few[1, [7, N - 5]] = pix[1, [7, N - 5]]  # two real refs
        q_sub = pts[:, :FUSION_SUBSET].contiguous()
        same(torch, "knn_fusion config #3 rows with fewer than k real refs",
             tuple(x[:, :FUSION_SUBSET] for x in fusion.knn(pts, few, k)), reference.knn(q_sub, few, k))
        print("  knn_fusion config #3 rows with fewer than k real refs: equal", flush=True)
        del few
        case = fusion_case(torch, pts, pix, k, f"{B}x{M} queries over {N} refs, k={k}", subset=FUSION_SUBSET)
        out = {"knn_fusion": measure(torch, dict(case, reps=10))}
        sa1 = cfg.model.pn2.sa[0]
        out["fps_perrow"] = measure(torch, dict(
            name="fps_perrow", shape=f"{B}x{M} points -> {sa1.npoint} (SA1)", reps=5,
            kern=lambda: fps.farthest_point_sample(pts, sa1.npoint),
            plain=lambda: reference.farthest_point_sample(pts, sa1.npoint), library=None,
            ops=10.0 * B * (sa1.npoint - 1) * M, nbytes=4.0 * (3 * B * M + B * sa1.npoint),
            extra={"cluster": fps.CLUSTER, "max_active_clusters": fps.cluster_occupancy(M, pts.device)},
        ))
        out.update(path_rows(torch, cfg, pts))  # rows 2-4: SA2-SA4 FPS, SA1-SA4, FP1-FP4
    return out


def shapes_phase(torch) -> tuple[dict, dict]:
    """10: configs #3 and #4 at their shapes through mvpnet_torch.config_shapes
    (the counts asserted a step there): config #3's step (B=32 as 4 x B8,
    N=32,768, V=3) with remat off and on, the first microbatch of each held
    against the plain versions; train_entry at config #3, its first
    microbatch held too, and rows 1-5 on it; config #4's training microbatch
    (B=2, N=102,400, V=8) with remat off and on. Returns (summary, rows)."""
    import dataclasses

    from mvpnet_torch import config_shapes, ops
    from mvpnet_torch.config import load_config
    from mvpnet_torch.entry import example_batch, to_device

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    cfg3 = load_config(config_shapes.CONFIG3, SYNTHETIC)
    summary = {"config3": config_shapes.train_shape(cfg3, dev, SHAPES_STEPS, "config #3")}
    d = cfg3.data
    batch = to_device(example_batch(np.random.default_rng(0), B=cfg3.train.batch_size, N=d.num_points,
                                    V=d.num_views_train, H=d.image_height, W=d.image_width,
                                    num_classes=d.num_classes), dev)
    summary["config3_parity"] = {}
    for variant, remat in (("base", False), ("remat", True)):
        cfg = dataclasses.replace(cfg3, train=dataclasses.replace(cfg3.train, remat=remat))
        summary["config3_parity"][variant] = microbatch_parity(torch, ops, cfg, batch, f"config #3 {variant}")
    del batch
    summary["config3_entry"], first = config_shapes.entry_steps(cfg3, dev, SHAPES_ENTRY_STEPS)
    summary["config3_entry_parity"] = microbatch_parity(torch, ops, cfg3, first, "config #3 train_entry")
    rows = train32k_rows(torch, cfg3, first)
    for name, row in rows.items():  # a config #3 step's launches of each kernel
        row["launches"] = summary["config3"]["base"]["launches_per_step"][name]
    del first
    torch.cuda.empty_cache()
    cfg4 = load_config(config_shapes.CONFIG4, SYNTHETIC)
    summary["config4_train"] = config_shapes.train_shape(cfg4, dev, SHAPES_STEPS, "config #4 train")
    summary["seconds"] = time.perf_counter() - t0
    print(f"  shapes phase: {summary['seconds']:.1f} s", flush=True)
    return summary, rows


def shapes_launches(shapes: dict, runbook: dict, name: str) -> dict:
    """A kernel's launches on each path of the shapes and runbook phases."""
    return {
        "config3_step": shapes["config3"]["base"]["launches_per_step"][name],
        "config3_remat_step": shapes["config3"]["remat"]["launches_per_step"][name],
        "config3_train_entry_step": shapes["config3_entry"]["launches_per_step"][name],
        "config3_microbatch_check": shapes["config3_parity"]["base"]["launches"][name],
        "config4_train_step": shapes["config4_train"]["base"]["launches_per_step"][name],
        "config4_train_remat_step": shapes["config4_train"]["remat"]["launches_per_step"][name],
        **{f"runbook_{mode}": run["launches"][name] for mode, run in runbook["test_3d"].items()},
    }


def runbook_launches(log_path: str) -> dict:
    """The "kernel launches since start" dict a cli.test_3d log ends with."""
    import ast

    with open(log_path) as f:
        lines = [ln for ln in f if "kernel launches since start:" in ln]
    if not lines:
        fail(f"{log_path}: no kernel launch line")
    return ast.literal_eval(lines[-1].split("kernel launches since start:", 1)[1].strip())


def run_runbook(cmd: list, what: str) -> dict:
    """Run the runbook; its {"stages": ...} line."""
    proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
                          timeout=RUNBOOK_TIMEOUT)
    if proc.returncode != 0:
        fail(f"runbook ({what}) exited {proc.returncode}: {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    stages = [json.loads(ln)["stages"] for ln in proc.stdout.splitlines() if ln.startswith('{"stages"')]
    if len(stages) != 1:
        fail(f"runbook ({what}): no stages line in {proc.stdout[-2000:]}")
    return stages[0]


def runbook_eval_parity(torch, ops, stage, what: str) -> dict:
    """A runbook test_3d stage's command in process, through the kernels and
    with set_impl("reference"): the index ops (with ``knn_prepared``, the
    fused mode's search) called in the same order with equal outputs; the
    reference run launches nothing. Returns the count, each op's first
    output shapes and both runs' mIoUs."""
    from mvpnet_torch.cli import test_3d

    argv = stage.cmd[stage.cmd.index("mvpnet_torch.cli.test_3d") + 1:]
    logs, mious, counts = {}, {}, {}
    for impl in ("auto", "reference"):
        ops.set_impl(impl)
        try:
            ops.reset_launch_counts()
            with recording(ops, INDEX_OPS + ("knn_prepared",)) as log:
                mious[impl] = cli_json(test_3d.main, argv)["miou"]
            torch.cuda.synchronize()
            counts[impl] = ops.launch_counts()
        finally:
            ops.set_impl("auto")
        logs[impl] = log
    if any(counts["reference"].values()):
        fail(f"{what} reference run launched kernels: {counts['reference']}")
    if not all(counts["auto"][k] for k in ("knn_fusion", "fps", "ball_query", "knn")):
        fail(f"{what}: kernel launches {counts['auto']}, want rows 1-4")
    n_equal = compare_logs(torch, logs["auto"], logs["reference"], what)
    shapes = {n: [list(o.shape) for o in outs] for n, outs in reversed(logs["auto"])}  # each op's first call
    print(f"  {what} in process through the plain versions: {n_equal} index-op outputs equal; mIoU {mious['auto']} "
          f"(kernels) / {mious['reference']} (plain); first output shapes {shapes}", flush=True)
    return {"index_op_outputs_equal": n_equal, "first_output_shapes": shapes, "miou": mious,
            "launches": counts["auto"]}


def runbook_phase(torch) -> dict:
    """11: mvpnet_torch.runbook --smoke on the card over a fake raw ScanNet
    tree of RAW_SCANS scans (write_raw_scan), in outputs/chip_smoke_runbook
    (removed after): every stage runs and exits 0; each test_3d mode's
    forwards launch rows 1-4, 1/4/0/4/4 a forward (its log's launch line);
    the report has every key; a second invocation runs no stage; the JAX
    package's runs/scannet_smoke_*.json do not change. Then each test_3d
    stage's command in process against the plain versions
    (runbook_eval_parity), so the kernels are held at the smoke shapes."""
    import glob
    import hashlib
    import shutil

    from mvpnet_torch import ops, runbook

    root = os.path.dirname(os.path.abspath(__file__))
    jax_files = sorted(glob.glob(os.path.join(root, "runs", "scannet_smoke_*.json")))

    def digests():
        return {f: hashlib.sha256(open(f, "rb").read()).hexdigest() for f in jax_files}

    before = digests()
    t0 = time.perf_counter()
    directory = os.path.join(root, "outputs", "chip_smoke_runbook")
    shutil.rmtree(directory, ignore_errors=True)
    try:
        raw = os.path.join(directory, "raw")
        for i in range(RAW_SCANS):
            write_raw_scan(raw, f"scene{i:04d}_00", seed=i)
        cmd = [sys.executable, "-m", "mvpnet_torch.runbook", "--raw", raw, "--smoke", "--root", directory]
        first = run_runbook(cmd, "first run")
        first_s = time.perf_counter() - t0
        if set(first.values()) != {"ran"}:
            fail(f"runbook first run: stages {first}")
        smoke = os.path.join(directory, "outputs", "torch_runbook_smoke")
        with open(os.path.join(smoke, "scannet_smoke_parity.json")) as f:
            report = json.load(f)
        if tuple(report) != runbook.REPORT_KEYS or report["smoke"] is not True:
            fail(f"runbook report keys {list(report)}, want {runbook.REPORT_KEYS}")
        modes = [m for m, _ in runbook.EVAL_MODES]
        if sorted(report["measured"]) != sorted(modes) or not all(0 <= v <= 1 for v in report["measured"].values()):
            fail(f"runbook report measured {report['measured']}")
        test_3d = {}
        for mode in modes:
            counts = runbook_launches(os.path.join(smoke, "logs", f"test_3d_{mode}.log"))
            forwards = counts["knn_fusion"]
            want = dict.fromkeys(counts, 0)
            want.update(knn_fusion=forwards, fps=4 * forwards, ball_query=4 * forwards, knn=4 * forwards)
            if forwards < 1 or counts != want:
                fail(f"runbook test_3d {mode}: launches {counts}, want 1/4/0/4/4 a forward")
            test_3d[mode] = {"forwards": forwards, "launches": {k: n / forwards for k, n in counts.items()}}
        second = run_runbook(cmd, "second run")
        if set(second.values()) != {"done"}:
            fail(f"runbook second run: stages {second}")
        args = runbook.parse_args(cmd[cmd.index("--raw"):])
        for stage in runbook.plan(args, runbook.paths(args)):
            if stage.result is not None:
                mode = stage.name.removeprefix("test_3d_")
                test_3d[mode]["parity"] = runbook_eval_parity(torch, ops, stage, f"runbook test_3d {mode}")
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    if digests() != before:
        fail("the runbook changed the JAX package's runs/scannet_smoke_*.json")
    seconds = time.perf_counter() - t0
    print(f"  runbook --smoke: stages {first}, {first_s:.1f} s; report {report['measured']}; test_3d forwards "
          f"{ {m: r['forwards'] for m, r in test_3d.items()} } each 1/4/0/4/4; second run: {second}; phase "
          f"{seconds:.1f} s", flush=True)
    return {"stages": first, "second_run": second, "report": report, "test_3d": test_3d, "first_run_s": first_s,
            "seconds": seconds}


def dist_launches(summary: dict, name: str) -> dict:
    """A kernel's launches on each path of the dist phase."""
    out = {"nccl_train_step": summary["nccl_world1"]["launches_per_step"][name]}
    for row in summary["ring"]:
        out[f"ring_pass_space{row['space']}"] = row["launches"] if name == "knn_fusion" else 0
    out["sharded_scene_pass"] = summary["sharded_scene"]["launches_per_pass"][name]
    return out


def main() -> None:
    # cuBLAS reads its workspace setting at its first call; the deterministic
    # mode of the dist phase needs this one (the H100's default size)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE_CONFIG)
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
    torch.cuda.empty_cache()
    print("dist phase:", flush=True)
    dist = dist_phase(torch)
    torch.cuda.empty_cache()
    print("shapes phase:", flush=True)
    shapes, shapes_rows = shapes_phase(torch)
    torch.cuda.empty_cache()
    print("runbook phase:", flush=True)
    runbook = runbook_phase(torch)
    torch.cuda.empty_cache()
    print("e2e phase:", flush=True)
    e2e = e2e_phase(torch)

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
        row["dist_launches"] = dist_launches(dist, row["name"])
        row["e2e_launches"] = e2e_launches(e2e, row["name"])
        row["shapes_launches"] = shapes_launches(shapes, runbook, row["name"])
        if row["name"] in shapes_rows:  # config #3's train path
            row["train32k_path"] = path(shapes_rows[row["name"]])
    print(json.dumps({"slice": summary}), flush=True)
    print(json.dumps({"scene": scene_summary}), flush=True)
    print(json.dumps({"train": train_summary}), flush=True)
    serve = recipe["cli"].pop("serve")
    print(json.dumps({"recipe": recipe}), flush=True)
    print(json.dumps({"serve": serve}), flush=True)
    print(json.dumps({"dist": dist}), flush=True)
    print(json.dumps({"shapes": shapes}), flush=True)
    print(json.dumps({"runbook": runbook}), flush=True)
    print(json.dumps({"e2e": e2e}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card_line(), flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
