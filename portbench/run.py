"""Run one benchmark cell once on the card and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Measures the PyTorch/CUDA port (``mvpnet_torch``) only. Set-up makes the
cell's scenes and the model's weights from ``--seed``, builds the cell's
path and warms it; the window then runs the cell's closed loop for
``--seconds``; with ``--trace 1`` under ``torch.profiler``. After the window
the plain reference (``portbench/reference``) checks what the window's path
produced. The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit,
which also end standard error. Exits non-zero, printing no result, without
enough CUDA cards or when JAX, flax or the JAX package got loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402
from portbench.trace import Tracer  # noqa: E402


class Context:
    """What a driver gets: the cell's files, the run's arguments, the device,
    the tracer, the record it fills, and the scene corpus (already being
    made)."""

    def __init__(self, manifest, cell: str, seed: int, seconds: float, trace: bool, device, t0: float,
                 program_dtype: str | None = None):
        import torch

        from portbench.traffic.synthetic import Corpus

        self.cell = manifest.cell(cell)
        self.cfg = manifest.config(self.cell["config"])["config"]
        self.traffic = manifest.traffic(self.cell["traffic"])
        self.seed, self.seconds, self.t0 = int(seed), float(seconds), t0
        self.device = torch.device(device)
        self.tracer = Tracer(trace, cuda=self.device.type == "cuda")
        self.record = harness.Run(cell=cell, cfg=self.cfg, traffic=self.traffic)
        self.program_cfg = harness.program_config(self.cfg, program_dtype)
        self.corpus = Corpus(self.traffic, self.cfg, self.seed)

    def mark(self, what: str) -> None:
        """A line on standard error: seconds since the process started."""
        print(f"portbench: {time.perf_counter() - self.t0:8.2f} s {what}", file=sys.stderr, flush=True)

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            import torch

            torch.cuda.synchronize(self.device)

    def peak_bytes(self) -> int:
        import torch

        return int(torch.cuda.max_memory_allocated(self.device)) if self.cuda else 0

    def reset_peak(self) -> None:
        if self.cuda:
            import torch

            torch.cuda.reset_peak_memory_stats(self.device)

    def free(self) -> None:
        gc.collect()
        if self.cuda:
            import torch

            torch.cuda.empty_cache()


def run_cell(root: str, cell: str, seed: int, seconds: float, trace: bool, device, t0: float | None = None,
             program_dtype: str | None = None) -> tuple[dict, harness.Run]:
    """Run a cell; (its result object, the run's record with every number the
    check computed). Without the card checks of ``main``: a test passes
    ``device="cpu"``. ``program_dtype`` runs the program's networks in another
    precision than the configuration's (a witness, never the benchmark)."""
    manifest = harness.Manifest(root)
    ctx = Context(manifest, cell, seed, seconds, trace, device, T0 if t0 is None else t0, program_dtype)
    try:
        ctx.mark("imports, config, scene pool started")
        driver = manifest.driver(ctx.traffic["driver"])
        rec = driver.run(ctx)
        rec.trace = ctx.tracer.trace
    finally:
        ctx.corpus.close()
    from portbench import compare

    ok, checks = compare.judge(rec.numbers, ctx.cell["limits"])
    metrics = {}
    for m in manifest.metrics_of(cell, trace):
        value = manifest.reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": bool(ok and rec.failed == 0),
        "attempted": rec.attempted,
        "failed": rec.failed,
        "metrics": metrics,
        "device": device_info(ctx, rec),
    }
    if trace and rec.trace is not None:
        result["breakdown"] = rec.trace.breakdown()
    result["checks"] = checks
    parse = rec.trace.parse_s if rec.trace is not None else 0.0
    print(f"portbench: {cell} seed {seed}: set-up {rec.setup_s:.2f} s, window {rec.window_s:.2f} s, "
          f"trace read {parse:.2f} s, after the window {time.perf_counter() - ctx.t0 - rec.setup_s - rec.window_s:.2f} s",
          file=sys.stderr)
    return result, rec


def device_info(ctx: Context, rec) -> dict:
    import torch

    info = {
        "platform": "gpu" if ctx.cuda else "cpu",
        "kind": torch.cuda.get_device_name(ctx.device) if ctx.cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": rec.peak_bytes,
    }
    if rec.trace is not None:
        info["busy_s"] = rec.trace.busy_s()
        info["window_s"] = rec.trace.window_s
    return info


def card_line() -> str:
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    import torch

    chips = harness.Manifest(ROOT).cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result, _ = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), "cuda")
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX, flax or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    print(f"card: {card_line()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
