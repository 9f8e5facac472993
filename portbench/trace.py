"""The traced window: device intervals from ``torch.profiler``, host ranges.

A ``--trace 1`` run profiles its whole measured window. The benchmark puts
``record_function`` ranges around its own calls into each layer
(``data_wait``, ``step``, ``chunk_build_and_fill``, ``forward``); the
device's busy time is the union of every device operation's interval
(kernels, copies, sets), so operations on several streams are not counted
twice. ``PORT_KERNELS`` names the device symbols of each CUDA source of the
port (copied from ``mvpnet_torch/profile_request.py``).
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

PORT_KERNELS = {
    "knn_fusion": ("knn_slice_kernel", "knn_merge_kernel", "knn_demand_kernel"),
    "fps": ("fps_shared_kernel",),
    "fps_perrow": ("fps_cluster_kernel",),
    "ball_query": ("ball_query_kernel",),
    "knn": ("knn_brute_kernel",),
    "knn_gated": ("knn_gated_kernel",),
    "knn_resident": ("knn_resident_kernel",),
    "morton_prep": ("morton_box_kernel", "morton_codes_kernel", "morton_sort_pass_kernel", "morton_gather_kernel",
                    "morton_order_kernel"),
}
RANGES = ("data_wait", "step", "chunk_build_and_fill", "forward")
TOP = 10


@dataclass
class Trace:
    """What a traced window left: device operations (name, start s, end s),
    host ranges (name, start s, end s), the window's bounds."""

    ops: list = field(default_factory=list)
    ranges: list = field(default_factory=list)
    start: float = 0.0
    end: float = 0.0
    parse_s: float = 0.0

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy())

    def busy(self) -> list:
        """The union of the device operations' intervals, within the window."""
        return union((max(s, self.start), min(e, self.end)) for _, s, e in self.ops if e > self.start and s < self.end)

    def kernel(self, name: str) -> list:
        """Device operations of the port kernel ``name`` (PORT_KERNELS)."""
        symbols = PORT_KERNELS[name]
        return [op for op in self.ops if any(s in op[0] for s in symbols)]

    def breakdown(self) -> dict:
        by_name: dict[str, float] = {}
        for name, s, e in self.ops:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
        top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:TOP]
        gaps = []
        prev = self.start
        for s, e in self.busy() + [(self.end, self.end)]:
            if s > prev:
                gaps.append((self.host_at((prev + s) / 2), s - prev))
            prev = max(prev, e)
        gaps.sort(key=lambda g: g[1], reverse=True)
        return {"device_ops": [[n[:160], v] for n, v in top], "idle_gaps": [[n, v] for n, v in gaps[:TOP]]}

    def host_at(self, t: float) -> str:
        """The innermost benchmark range open at time ``t``."""
        inside = [(e - s, n) for n, s, e in self.ranges if s <= t <= e]
        return min(inside)[1] if inside else "outside_ranges"


def union(pairs) -> list:
    """Merged (start, end) intervals of ``pairs``, in order."""
    out: list = []
    for s, e in sorted(pairs):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


class Tracer:
    """``with tracer:`` profiles the window when enabled; ``tracer.range(name)``
    marks a host range (a no-op when disabled). ``tracer.trace`` is filled
    on exit."""

    def __init__(self, enabled: bool, cuda: bool = True):
        self.enabled = enabled
        self.cuda = cuda
        self.trace: Trace | None = None
        self._prof = None

    def range(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)

    def __enter__(self):
        if self.enabled:
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            if self.cuda:
                torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        if not self.enabled:
            return False
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            t0 = time.perf_counter()
            self.trace = _read(self._prof)
            self.trace.parse_s = time.perf_counter() - t0
        self._prof = None
        return False


def _read(prof) -> Trace:
    """The window's device operations and benchmark ranges, from the
    profiler's raw events (building its event tree for a window of tens of
    thousands of launches takes minutes)."""
    from torch.autograd import DeviceType

    tr = Trace()
    for evt in prof.profiler.kineto_results.events():
        name = evt.name()
        s, e = evt.start_ns() / 1e9, evt.end_ns() / 1e9
        if evt.device_type() == DeviceType.CUDA:
            if not evt.is_user_annotation():
                tr.ops.append((name, s, e))
        elif name in RANGES:
            tr.ranges.append((name, s, e))
    if tr.ranges:
        tr.start = min(r[1] for r in tr.ranges)
        tr.end = max(r[2] for r in tr.ranges)
    return tr
