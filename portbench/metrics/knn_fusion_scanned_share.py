"""Row 1's waste: the (query, ref) pairs the fusion kNN's kernels scanned in
the window (the program's counter ``knn_fusion.pairs_scanned``,
``mvpnet_torch/tracing.py``, which counts only while a profiler records: in
the traced window) over every pair of the window's fusion searches, rows x
queries x refs of ``counts.fusion_knn_call`` a forward at the eval views.
None without a trace, without the counter, or unless the program launched
row 1 once a forward."""
from portbench import counts

LAYER = "kernels"
UNIT = "%"
MOVES = "scenes_per_hour"
SOURCE = "program_counter"


def read(run):
    if run.trace is None or not run.forwards or run.launches.get("knn_fusion") != len(run.forwards):
        return None
    try:
        from mvpnet_torch import tracing
    except ImportError:  # a program without the counter
        return None
    scanned = tracing.counters().get("knn_fusion.pairs_scanned", 0)
    views = run.cfg["data"]["num_views_eval"]
    pairs = 0
    for rows in run.forwards:
        b, m, n, _ = counts.fusion_knn_call(run.cfg, rows, views)
        pairs += b * m * n
    return 100.0 * scanned / pairs if scanned else None
