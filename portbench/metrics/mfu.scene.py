"""Model FLOPs of the window's whole-scene forwards (``counts.window_forward_flops``
a window) over the window's seconds and the published bf16 dense peak."""
from portbench import counts

LAYER = "model step"
UNIT = "%"
MOVES = "scenes_per_hour"
SOURCE = "host_clock"


def read(run):
    if not run.forwards or not any("scene_s" in u for u in run.units):
        return None
    return 100.0 * sum(run.forwards) * counts.window_forward_flops(run.cfg) / run.window_s / counts.BF16_DENSE_FLOPS
