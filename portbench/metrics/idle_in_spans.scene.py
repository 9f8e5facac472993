"""Share of the traced window's device-idle time that the program's spans
name: the idle intervals (the window less the union of device operations,
``trace.busy()``) covered by the spans below the root ``scene.predict`` on
its own thread (``scene.windows``, ``scene.chunk_wait``, ``scene.transfer``,
``scene.forward``, ``scene.accumulate``, ``scene.readback``,
``scene.nn_fill``, ``model.*``; the pool's ``scene.chunk_build`` runs on
other threads; ``mvpnet_torch/tracing.py``). None without a trace or without
the spans."""
from portbench.trace import union

LAYER = "device"
UNIT = "%"
MOVES = "scenes_per_hour"
SOURCE = "program_counter"
ROOTS = ("scene.predict",)


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    try:
        from mvpnet_torch import tracing
    except ImportError:  # a program without spans
        return None
    spans = tracing.spans(run.trace.start, run.trace.end)
    roots = {s.id: s.thread for s in spans if s.parent is None and s.name in ROOTS}
    below = union((s.start_ns / 1e9, s.end_ns / 1e9) for s in spans
                  if s.parent is not None and roots.get(s.root) == s.thread)
    idle, prev = [], run.trace.start
    for s, e in run.trace.busy() + [(run.trace.end, run.trace.end)]:
        if s > prev:
            idle.append((prev, s))
        prev = max(prev, e)
    total = sum(e - s for s, e in idle)
    if not below or total <= 0:
        return None
    return 100.0 * overlap(idle, below) / total


def overlap(a: list, b: list) -> float:
    """Length of the intersection of two sorted lists of disjoint intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total
