#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (mvpnet_torch) on one GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each of which fails the run with a nonzero exit:
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. build every CUDA kernel from mvpnet_torch/csrc (one nvcc per source, all
     at once) and print the build seconds;
  3. kernels: at the shapes the main path gives them, plus masked/sentinel,
     duplicate-point and two-row cases (and FPS rows too long for shared
     memory), each kernel must equal its plain
     PyTorch version on the card (indices and counts equal, distances bit
     for bit); each is timed with CUDA events beside its plain version, a
     one-call PyTorch yardstick where one exists, and its bound;
  4. slice: entry() at the default Config() (full width, bf16, B=1, N=8192,
     V=5 views of 120x160) answers 5 requests, each on a fresh numpy-seeded
     batch; every request must launch each kernel the expected number of
     times and return finite (1, 8192, 20) logits; one request is answered
     again with set_impl("reference") and must give the same index outputs
     and argmaxes; one request in the compact wire format (uint8 / uint16 /
     int16) must answer as its dequantized float32 twin.
Then it prints the {"kernels": [...]} line, the card line, and last
{"ok": true, "device": {...}}. Without CUDA, or without the mvpnet_torch
package beside it, it exits nonzero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np

# published peaks of one H100 SXM at its full 700 W (NVIDIA data sheet):
# f32 outside the tensor cores, and HBM3 bandwidth
F32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
KERNEL_REPS = 30
PLAIN_REPS = 5
# per request: fusion kNN once, FPS / ball query / three-NN once per level
EXPECTED_LAUNCHES = {"knn_fusion": 1, "fps": 4, "ball_query": 4, "knn": 4}
TPU_KERNELS = {
    "knn_fusion": ("mvpnet_torch/csrc/knn_fusion.cu", "mvpnet_tpu/ops/pallas/knn_bucketed.py:238"),
    "fps": ("mvpnet_torch/csrc/fps.cu", "mvpnet_tpu/ops/pallas/fps.py:83"),
    "ball_query": ("mvpnet_torch/csrc/ballquery.cu", "mvpnet_tpu/ops/pallas/ballquery.py:39"),
    "knn": ("mvpnet_torch/csrc/knn.cu", "mvpnet_tpu/ops/pallas/knn.py:76"),
}


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
    t_ops, t_bytes = ops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


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
    # rows too long for shared memory: fps.cu's device-memory loop
    long_rows = rnd(2, 20000, 3)
    checks = [
        ("knn_fusion batch of 2", lambda: fusion.knn(pts_batch, pix_batch, k), lambda: reference.knn(pts_batch, pix_batch, k)),
        ("fps long rows, batch of 2", lambda: fps.farthest_point_sample(long_rows, 256), lambda: reference.farthest_point_sample(long_rows, 256)),
        ("knn_fusion sentinel", lambda: fusion.knn(pts, pix_sentinel, k), lambda: reference.knn(pts, pix_sentinel, k)),
        ("knn_fusion duplicates", lambda: fusion.knn(pts, pix_dup, k), lambda: reference.knn(pts, pix_dup, k)),
        ("fps masked", lambda: fps.farthest_point_sample(pts, sa1.npoint, valid), lambda: reference.farthest_point_sample(pts, sa1.npoint, valid)),
        ("fps duplicates", lambda: fps.farthest_point_sample(pts_dup, sa1.npoint), lambda: reference.farthest_point_sample(pts_dup, sa1.npoint)),
        ("ball_query masked", lambda: bq.ball_query(c1, pts, sa1.radius, sa1.nsample, valid), lambda: reference.ball_query(c1, pts, sa1.radius, sa1.nsample, valid)),
        ("ball_query duplicates", lambda: bq.ball_query(c1, pts_dup, sa1.radius, sa1.nsample), lambda: reference.ball_query(c1, pts_dup, sa1.radius, sa1.nsample)),
        ("ball_query empty balls", lambda: bq.ball_query(c1 + 50.0, pts, sa1.radius, sa1.nsample), lambda: reference.ball_query(c1 + 50.0, pts, sa1.radius, sa1.nsample)),
        ("knn masked refs", lambda: brute.knn(pts, reference.mask_points(c1, valid[:, : c1.shape[1]]), 3), lambda: reference.knn(pts, reference.mask_points(c1, valid[:, : c1.shape[1]]), 3)),
        ("knn duplicates", lambda: brute.knn(pts, torch.cat([c1, c1], 1), 3), lambda: reference.knn(pts, torch.cat([c1, c1], 1), 3)),
    ]
    # ragged edges: tails of tiles, slices and warps; k = N; K > 32; npoint > N
    q37, r5, r2049, q300, r33k, p33, p5, p100 = (
        rnd(2, 37, 3), rnd(2, 5, 3), rnd(1, 2049, 3), rnd(2, 300, 3), rnd(2, 33000, 3), rnd(3, 33, 3), rnd(1, 5, 3), rnd(2, 100, 3)
    )
    checks += [
        ("knn edges k=N", lambda: brute.knn(q37, r5, 5), lambda: reference.knn(q37, r5, 5)),
        ("knn edges tile tail k=8", lambda: brute.knn(q37[:1], r2049, 8), lambda: reference.knn(q37[:1], r2049, 8)),
        ("knn_fusion edges k=8", lambda: fusion.knn(q300, r33k, 8), lambda: reference.knn(q300, r33k, 8)),
        ("fps edges npoint=N", lambda: fps.farthest_point_sample(p33, 33), lambda: reference.farthest_point_sample(p33, 33)),
        ("fps edges npoint>N", lambda: fps.farthest_point_sample(p5, 8), lambda: reference.farthest_point_sample(p5, 8)),
        ("ball_query edges K=N", lambda: bq.ball_query(q37, p100[:, :40], 1.5, 40), lambda: reference.ball_query(q37, p100[:, :40], 1.5, 40)),
        ("ball_query edges K=64", lambda: bq.ball_query(q37, p100, 2.0, 64), lambda: reference.ball_query(q37, p100, 2.0, 64)),
    ]
    for name, kern, plain in checks:
        same(torch, name, kern(), plain())
        print(f"  {name}: equal", flush=True)

    B, M, N, Nc = pts.shape[0], pts.shape[1], pix.shape[1], c1.shape[1]
    bq_idx, bq_cnt = reference.ball_query(c1, pts, sa1.radius, sa1.nsample)
    # pairs the ball query's walk needs: up to its K-th hit, else every point
    bq_pairs = torch.where(bq_cnt == sa1.nsample, bq_idx[..., -1].long() + 1, M).sum().item()
    main = [
        dict(
            name="knn_fusion", shape=f"{B}x{M} queries over {N} refs, k={k}",
            kern=lambda: fusion.knn(pts, pix, k), plain=lambda: reference.knn(pts, pix, k),
            library=lambda: torch.cdist(pts, pix),
            ops=9.0 * B * M * N, nbytes=4.0 * (3 * B * M + 3 * B * N + 2 * B * M * k),
        ),
        dict(
            name="fps", shape=f"{B}x{M} points -> {sa1.npoint}",
            kern=lambda: fps.farthest_point_sample(pts, sa1.npoint),
            plain=lambda: reference.farthest_point_sample(pts, sa1.npoint),
            library=None,
            ops=10.0 * B * (sa1.npoint - 1) * M, nbytes=4.0 * (3 * B * M + B * sa1.npoint),
        ),
        dict(
            name="ball_query", shape=f"{B}x{Nc} centers over {M} points, r={sa1.radius}, K={sa1.nsample}",
            kern=lambda: bq.ball_query(c1, pts, sa1.radius, sa1.nsample),
            plain=lambda: reference.ball_query(c1, pts, sa1.radius, sa1.nsample),
            library=lambda: torch.cdist(c1, pts),
            ops=9.0 * bq_pairs, nbytes=4.0 * (3 * B * Nc + 3 * B * M + B * Nc * (sa1.nsample + 1)),
        ),
        dict(
            name="knn", shape=f"{B}x{M} queries over {Nc} refs, k=3",
            kern=lambda: brute.knn(pts, c1, 3), plain=lambda: reference.knn(pts, c1, 3),
            library=lambda: torch.cdist(pts, c1),
            ops=9.0 * B * M * Nc, nbytes=4.0 * (3 * B * M + 3 * B * Nc + 2 * B * M * 3),
        ),
    ]
    rows = []
    for case in main:
        err = same(torch, case["name"], case["kern"](), case["plain"]())
        ms = cuda_ms(torch, case["kern"], KERNEL_REPS)
        plain_ms = cuda_ms(torch, case["plain"], PLAIN_REPS, warmup=1)
        lib_ms = cuda_ms(torch, case["library"], KERNEL_REPS) if case["library"] else None
        b_ms, b_by = bound_ms(case["ops"], case["nbytes"])
        source, replaces = TPU_KERNELS[case["name"]]
        rows.append(
            {
                "name": case["name"], "route": "cuda", "source": source, "replaces": replaces,
                "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms, "shape": case["shape"],
            }
        )
        print(f"  {case['name']} [{case['shape']}]: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, "
              f"library {lib_ms}, bound {b_ms:.6f} ms ({b_by})", flush=True)
    return rows


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
    if [n for n, _ in got_log] != [n for n, _ in want_log]:
        fail("kernel and reference requests called different ops")
    for (name, g), (_, w) in zip(got_log, want_log):
        same(torch, f"slice {name}", g, w)
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    if agree <= 0.999:
        fail(f"argmax agreement with the reference path {agree}")
    print(f"  reference request: {reference_ms:.3f} ms, {len(got_log)} index-op outputs equal, "
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


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a CUDA card")
    from mvpnet_torch.config import Config
    from mvpnet_torch.entry import entry, to_device
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
        rows = kernel_phase(torch, cfg, prepared)
    print("slice phase:", flush=True)
    summary = slice_phase(torch, forward, model, cfg, rows)
    print(json.dumps({"slice": summary}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card_line(), flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
