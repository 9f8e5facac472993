"""Row 5 (``fps_cluster_kernel``): its least possible time over its device
time in the trace. The port routes the longest rows to this kernel, so its
launches in a forward are the FPS calls of the finest levels, as many as it
launched (``counts.fps_calls``); bytes bound it (``counts.fps_seconds``)."""
from portbench import counts

LAYER = "kernels"
UNIT = "%"
MOVES = "train_chunks_per_s"
SOURCE = "device_trace"


def read(run):
    if run.trace is None:
        return None
    ops = run.trace.kernel("fps_perrow")
    forwards = len(run.forwards)
    if not ops or not forwards or len(ops) % forwards:
        return None
    per = len(ops) // forwards
    calls = counts.fps_calls(run.cfg, run.forwards[0])
    if per > len(calls):
        return None
    least = sum(counts.fps_seconds(*c) for c in calls[:per]) * forwards
    return 100.0 * least / sum(e - s for _, s, e in ops)
