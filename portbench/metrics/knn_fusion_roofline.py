"""Row 1 (the ``knn_fusion`` symbols: ``knn_demand_kernel``,
``knn_slice_kernel``, ``knn_merge_kernel``): the least possible time of the
window's fusion searches (``counts.knn_seconds``, one a forward, as the
program's launch counter shows) over those kernels' device time."""
from portbench import counts

LAYER = "kernels"
UNIT = "%"
MOVES = "scenes_per_hour"
SOURCE = "device_trace"


def read(run):
    if run.trace is None:
        return None
    ops = run.trace.kernel("knn_fusion")
    if not ops or run.launches.get("knn_fusion") != len(run.forwards):
        return None
    views = run.cfg["data"]["num_views_eval"]
    least = sum(counts.knn_seconds(*counts.fusion_knn_call(run.cfg, rows, views)) for rows in run.forwards)
    return 100.0 * least / sum(e - s for _, s, e in ops)
