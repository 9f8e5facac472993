"""Where the time of one inference request goes, on the card.

    python3 -m mvpnet_torch.profile_request [--requests 5]

Runs ``entry()`` at the default Config() (full width, bf16, B=1, N=8192,
V=5 views of 120x160): one warm-up request, then ``--requests`` requests
timed on the host clock (ending in a synchronize) without the profiler, then
the same requests under ``torch.profiler``. Prints one JSON line: the card,
request ms without and with the profiler, device busy ms per request (the
sum of kernel time, one stream, so kernels do not overlap), the device's
idle share of the profiled wall time, device ms per request of each ported
kernel, and the kernels with the most device time, grouped by family.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from mvpnet_torch.config import Config
from mvpnet_torch.entry import entry, example_batch

# device kernels of the port's CUDA sources, by csrc file
PORT_KERNELS = {
    "knn_fusion": ("knn_slice_kernel", "knn_merge_kernel"),
    "fps": ("fps_shared_kernel",),
    "fps_perrow": ("fps_perrow_kernel",),
    "ball_query": ("ball_query_kernel",),
    "knn": ("knn_brute_kernel",),
}
FAMILIES = (
    ("port kernels", "|".join(s for symbols in PORT_KERNELS.values() for s in symbols)),
    ("convolution", r"conv|xmma|implicit|cudnn|winograd|fft"),
    ("matmul", r"gemm|cutlass|cublas|Kernel2|s\d+gemm|sm90_"),
    ("copy/layout", r"copy|Memcpy|Memset|nchw|nhwc|transpose|cat|pad"),
    ("elementwise/reduce", r"elementwise|reduce|vectorized|unrolled|index|gather|scatter|batch_norm|upsample|max_pool"),
)


def _device_ms(evt) -> float:
    us = getattr(evt, "self_device_time_total", None)
    if us is None:
        us = evt.self_cuda_time_total
    return us / 1e3


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def breakdown(prof, n: int, wall_ms: float, unit: str) -> dict:
    """Device time of a profiled window of ``n`` units (requests, scenes):
    busy ms (the sum of kernel time, one stream, so kernels do not overlap),
    the idle share of ``wall_ms``, ms of each port kernel, ms by family, and
    the kernels with the most device time, each per unit."""
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(_device_ms(e) for e in kernels)
    per_kernel = {
        name: sum(_device_ms(e) for e in kernels if any(s in e.key for s in symbols)) / n
        for name, symbols in PORT_KERNELS.items()
    }
    families: dict[str, float] = {}
    for e in kernels:
        fam = next((f for f, pat in FAMILIES if re.search(pat, e.key, re.IGNORECASE)), "other")
        families[fam] = families.get(fam, 0.0) + _device_ms(e) / n
    top = sorted(kernels, key=_device_ms, reverse=True)[:12]
    return {
        f"device_busy_ms_per_{unit}": busy_ms / n,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        f"port_kernel_ms_per_{unit}": per_kernel,
        f"family_ms_per_{unit}": families,
        "top_kernels": [
            {"name": e.key[:90], f"ms_per_{unit}": _device_ms(e) / n, f"calls_per_{unit}": e.count / n} for e in top
        ],
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--requests", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_request needs a CUDA card")
    cfg = Config()
    forward, (model, batch) = entry()
    batches = [
        example_batch(
            np.random.default_rng(seed), B=1, N=cfg.data.num_points, V=cfg.data.num_views_eval,
            H=cfg.data.image_height, W=cfg.data.image_width, num_classes=cfg.data.num_classes,
        )
        for seed in range(1, args.requests + 1)
    ]
    forward(model, batch)  # warm-up
    torch.cuda.synchronize()

    def run() -> list[float]:
        ms = []
        for b in batches:
            t0 = time.perf_counter()
            forward(model, b)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return ms

    plain_ms = run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        traced_ms = run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    n = args.requests
    print(json.dumps({
        "card": card_line(),
        "requests": n,
        "request_ms": plain_ms,
        "request_ms_median": statistics.median(plain_ms),
        "profiled_request_ms": traced_ms,
        **breakdown(prof, n, wall_ms, "request"),
    }))


if __name__ == "__main__":
    main()
