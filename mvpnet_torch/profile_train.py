"""Where the time of a training step goes, on the card.

    python3 -m mvpnet_torch.profile_train [--steps 5] [--grad-accum 1] [--variant demand]

Counterpart of ``tools/step_profile.py``. Runs ``train_entry()`` at the
training config (``configs/scannet/mvpnet_3d_unet_resnet34_pn2ssg.yaml`` on
synthetic scenes: full width, bf16 compute, B=8, N=8192, V=3 views of
120x160, random weights from seed 0), with the fusion kNN on ``--variant``.
Two warm-up steps, then ``--steps`` steps timed on the host clock (the wait
for the next batch apart from the step, which ends in a synchronize), then
the same number under ``torch.profiler``. Prints one JSON line: the card,
the step and data-wait times, chunks/s, peak device memory, device busy ms
per step, the device's idle share, device ms per step of each port kernel
and by family (convolution, matmul, optimizer, copies, elementwise).
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch
from torch.profiler import ProfilerActivity, profile

from mvpnet_torch import ops
from mvpnet_torch.config import load_config
from mvpnet_torch.entry import TRAIN_CONFIG, TRAIN_OVERRIDES, train_entry
from mvpnet_torch.profile_request import breakdown, card_line


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--grad-accum", type=int, default=1)
    parser.add_argument("--variant", default="demand", choices=ops.FUSION_VARIANTS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")
    cfg = load_config(TRAIN_CONFIG, TRAIN_OVERRIDES + [f"train.grad_accum={args.grad_accum}"])
    ops.set_fusion_variant(args.variant)
    step, (model, optimizer, batches) = train_entry(cfg=cfg)
    try:
        def run(n: int) -> tuple[list, list]:
            wait_ms, step_ms = [], []
            for _ in range(n):
                t0 = time.perf_counter()
                batch = next(batches)
                t1 = time.perf_counter()
                float(step(batch)["loss"])  # waits for the step
                torch.cuda.synchronize()
                wait_ms.append((t1 - t0) * 1e3)
                step_ms.append((time.perf_counter() - t1) * 1e3)
            return wait_ms, step_ms

        run(2)  # warm-up: cuDNN plans, the allocator, the kernels' build
        torch.cuda.reset_peak_memory_stats()
        wait_ms, step_ms = run(args.steps)
        peak = torch.cuda.max_memory_allocated()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            traced_wait, traced_step = run(args.steps)
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        batches.close()
    per_step = statistics.median(s + w for s, w in zip(step_ms, wait_ms))
    print(json.dumps({
        "card": card_line(),
        "config": "configs/scannet/mvpnet_3d_unet_resnet34_pn2ssg.yaml (data.name=synthetic)",
        "batch_size": cfg.train.batch_size,
        "grad_accum": cfg.train.grad_accum,
        "fusion_variant": args.variant,
        "steps": args.steps,
        "step_ms": step_ms,
        "data_wait_ms": wait_ms,
        "chunks_per_s": cfg.train.batch_size / (per_step / 1e3),
        "peak_memory_gib": peak / 2**30,
        "profiled_step_ms": traced_step,
        "profiled_data_wait_ms": traced_wait,
        **breakdown(prof, args.steps, wall_ms, "step"),
    }))


if __name__ == "__main__":
    main()
